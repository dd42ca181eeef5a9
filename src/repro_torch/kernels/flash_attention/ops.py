"""Flash-attention wrapper (counterpart of ``repro.kernels.flash_attention.ops``):
the CUDA kernels of ``csrc/flash_attention.cu`` for CUDA tensors, the plain
versions of ``ref.py`` for CPU tensors, and an autograd Function around
them.

The forward saves q, k, v, the output and the f32 log-sum-exp; the backward
launches the dQ kernel (which also writes Δ = rowsum(dO∘O)) and then the
dK/dV kernel. Each of the four wrappers counts its own launches. Unlike the
reference's wrapper, nothing is padded: neither the head dim to 128 lanes
nor the sequence to whole blocks (both TPU artifacts); the kernels
bounds-check their tiles and mask keys at or past ``sk_valid``.

Head dims 64, 80, 128 and 192 (DeepSeek-V3's MLA: 128 no-RoPE + 64 RoPE
columns; its v of 128 is zero-padded to 192 by the caller, as the
reference pads it for its Pallas kernel, and the output sliced back). At
192 the bf16 forward walks 64-key blocks (its plain version too), and the
bf16 dK/dV pass gives one warpgroup P and dV, the other dS and dK.

Routes, picked by the input dtype alone: bfloat16 runs the tensor-core
kernels (``wgmma``, tiles streamed by TMA into a ring), float32 the CUDA-core
ones (the tensor cores would take f32 only as TF32, which cannot meet the
f32 bounds). In bf16 the dK/dV pass may split each kv-head's group of
q-heads across CTAs (:func:`dkdv_splits`); the splits' f32 partials are then
summed in split order by a kernel of its own (:func:`dkdv_sum`, counted on
its own), so every run gives the same bits.

Kernel vs plain, stated bounds (checked on the card by ``chip_smoke.py``),
as max|kernel − plain| / max|plain|: f32 1e-5 for the output (and for the
f32 log-sum-exp, relative to max(1, |lse|)), 2e-5 for each gradient (the two sum in other orders and the
kernel contracts to FMA; observed ≤ 6e-7); bf16 2^-7 for the output and each
gradient (the forward rounds p to bf16 at the plain version's point, over
the same 128-key blocks; the backward rounds P and dS to bf16 as the tensor
cores' operands where the plain FlashAttention-2 backward keeps them in f32;
a value near a rounding boundary may round either way). Against torch
autograd of the plain forward, which rounds its intermediate gradients to
bf16 at the casts: 1e-4 (f32), 2^-5 (bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import I, Kernel, L, P, dtype_code, stream_ptr
from repro_torch.kernels.flash_attention import ref as _ref

_INTS = [I] * 11  # b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid, dtype
FWD = Kernel("flash_attention_fwd", {"flash_attention_fwd_launch": [P] * 5 + _INTS + [P]}, source="flash_attention")
BWD_DQ = Kernel("flash_attention_bwd_dq", {"flash_attention_bwd_dq_launch": [P] * 8 + _INTS + [P]},
                source="flash_attention")
BWD_DKDV = Kernel("flash_attention_bwd_dkdv", {"flash_attention_bwd_dkdv_launch": [P] * 8 + _INTS + [P, I, P]},
                  source="flash_attention")
BWD_DKDV_SUM = Kernel("flash_attention_dkdv_sum", {"flash_attention_dkdv_sum_launch": [P, P, P, L, I, P]},
                      source="flash_attention")
HEAD_DIMS = (64, 80, 128, 192)  # 192: DeepSeek-V3's MLA, v zero-padded from 128


def dkdv_splits(b: int, hkv: int, group: int, sk: int, sms: int) -> int:
    """Into how many CTAs the bf16 dK/dV kernel splits each kv-head's
    ``group`` q-heads, on a card of ``sms`` multiprocessors (the kernel
    gives split i the q-heads [i·group/n, (i+1)·group/n), none empty while
    n <= group). One CTA per (batch, kv-head, 128 keys) leaves most of the
    card idle at GQA shapes (2 · 4 · 4 = 32 CTAs at the qwen2 slice), and
    under a causal mask the first key blocks carry the most work, so the
    group is split until there are two CTAs for each SM or one q-head a
    split. Group 1 is never split."""
    if group == 1:
        return 1
    return min(group, -(-2 * sms // (b * hkv * -(-sk // 128))))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k, v, window, sk_valid):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,Sq,H,D) and k, v (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not match (GQA needs H % Hkv == 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if sk_valid is not None and not 0 <= sk_valid <= k.shape[1]:
        raise ValueError(f"flash_attention: sk_valid {sk_valid} outside [0, {k.shape[1]}]")


def _on_card(name: str, tensors, d: int) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim {HEAD_DIMS}, got {d}")


def _ints(q, k, causal, window, q_offset, sk_valid):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    return (b, sq, sk, h, hkv, d, int(bool(causal)), 0 if window is None else int(window), int(q_offset),
            sk if sk_valid is None else int(sk_valid), dtype_code(q.dtype))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                        sk_valid: Optional[int] = None):
    """(out (B,Sq,H,D), lse (B,H,Sq) f32). Replaces
    ``flash_attention/kernel.py::flash_attention_bhsd``."""
    _check(q, k, v, window, sk_valid)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    _on_card("flash_attention_fwd", (q, k, v), q.shape[3])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FWD.launch("flash_attention_fwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), *_ints(q, k, causal, window, q_offset, sk_valid), stream_ptr(q.device))
    return out, lse


def _bwd_inputs(name, tensors, q, k, v, window, sk_valid):
    _check(q, k, v, window, sk_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return None
    _on_card(name, tensors, q.shape[3])
    return tuple(t.contiguous() for t in tensors)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0, sk_valid: Optional[int] = None):
    """(dq, delta (B,H,Sq) f32) from the saved output and lse; the first of
    the two backward kernels (new for the port)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must match q")
    ready = _bwd_inputs("flash_attention_bwd_dq", (q, k, v, out, lse, dout), q, k, v, window, sk_valid)
    if ready is None:
        return _ref.flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw)
    q, k, v, out, lse, dout = ready
    b, sq, h, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    BWD_DQ.launch("flash_attention_bwd_dq_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  *_ints(q, k, causal, window, q_offset, sk_valid), stream_ptr(q.device))
    return dq, delta


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, *, causal: bool = True, window: Optional[int] = None,
                             q_offset: int = 0, sk_valid: Optional[int] = None):
    """(dk, dv), each summed over its kv-head's group in a fixed order; the
    second backward kernel (reads the dQ kernel's delta). In bf16 the group
    may be split (:func:`dkdv_splits`) into f32 partials, which
    :func:`dkdv_sum` then adds in split order."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    ready = _bwd_inputs("flash_attention_bwd_dkdv", (q, k, v, dout, lse, delta), q, k, v, window, sk_valid)
    if ready is None:
        return _ref.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
    q, k, v, dout, lse, delta = ready
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, sk, hkv, d = k.shape
    n = dkdv_splits(b, hkv, q.shape[2] // hkv, sk, _sms(q.device)) if q.dtype == torch.bfloat16 else 1
    part = torch.empty((2, n, b, sk, hkv, d), dtype=torch.float32, device=q.device) if n > 1 else None
    BWD_DKDV.launch("flash_attention_bwd_dkdv_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    *_ints(q, k, causal, window, q_offset, sk_valid), 0 if part is None else part.data_ptr(), n,
                    stream_ptr(q.device))
    return (dk, dv) if part is None else dkdv_sum(part, k.dtype)


def dkdv_sum(part, dtype):
    """(dk, dv) in ``dtype`` from the split dK/dV pass's f32 partials
    ``part`` (2, n, B, Sk, Hkv, D), dK's then dV's: each the sum over the n
    splits in split order, rounded once. The kernel takes bf16 only."""
    if part.device.type == "cpu":
        return _ref.dkdv_sum(part, dtype)
    if part.device.type != "cuda" or part.dtype != torch.float32 or part.dim() != 6 or part.shape[0] != 2:
        raise ValueError(f"dkdv_sum takes f32 partials (2, n, B, Sk, Hkv, D) on the card, got "
                         f"{part.dtype} {tuple(part.shape)} on {part.device}")
    if dtype != torch.bfloat16 or part.shape[1] < 2:
        raise ValueError(f"dkdv_sum: the kernel sums two or more splits into bf16, got {part.shape[1]} into {dtype}")
    part = part.contiguous()
    dk = torch.empty(part.shape[2:], dtype=dtype, device=part.device)
    dv = torch.empty_like(dk)
    BWD_DKDV_SUM.launch("flash_attention_dkdv_sum_launch", part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        dk.numel(), part.shape[1], stream_ptr(part.device))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, sk_valid: Optional[int] = None):
    """(dq, dk, dv) of the f32 attention: the dQ kernel, then the dK/dV kernel."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw)
    return (dq, *flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw))


class FlashAttention(torch.autograd.Function):
    """Forward kernel; backward kernels from the saved output and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D) -> (B,Sq,H,D); q pre-scaled. The
    reference's public ``flash_attention``, differentiable. When no gradient
    is wanted (serving's prefill) it is the forward alone: nothing is saved
    for a backward."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)[0]
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
