"""Flash-attention wrapper (counterpart of ``repro.kernels.flash_attention.ops``):
the CUDA kernels of ``csrc/flash_attention.cu`` for CUDA tensors, the plain
versions of ``ref.py`` for CPU tensors, and an autograd Function around
them.

The forward saves q, k, v, the output and the f32 log-sum-exp; the backward
launches the dQ kernel (which also writes Δ = rowsum(dO∘O)) and then the
dK/dV kernel. Each of the three wrappers counts its own launches. Unlike the
reference's wrapper, nothing is padded: neither the head dim to 128 lanes
nor the sequence to whole blocks (both TPU artifacts); the kernels
bounds-check their tiles and mask keys at or past ``sk_valid``.

Kernel vs plain, stated bounds (checked on the card by ``chip_smoke.py``),
as max|kernel − plain| / max|plain|: f32 1e-5 for the output (and for the
f32 log-sum-exp, relative to max(1, |lse|)), 2e-5 for each gradient (the two sum in other orders and the
kernel contracts to FMA; observed ≤ 6e-7); bf16 2^-7 for the output and each
gradient (both round p to bf16 at the same point and round each result
once, but a value near a rounding boundary may round either way; observed
≤ 2.3e-3). Against torch autograd of the plain forward, which rounds its
intermediate gradients to bf16 at the casts: 1e-4 (f32), 2^-5 (bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.flash_attention import ref as _ref

_INTS = [I] * 11  # b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid, dtype
FWD = Kernel("flash_attention_fwd", {"flash_attention_fwd_launch": [P] * 5 + _INTS + [P]}, source="flash_attention")
BWD_DQ = Kernel("flash_attention_bwd_dq", {"flash_attention_bwd_dq_launch": [P] * 8 + _INTS + [P]},
                source="flash_attention")
BWD_DKDV = Kernel("flash_attention_bwd_dkdv", {"flash_attention_bwd_dkdv_launch": [P] * 8 + _INTS + [P]},
                  source="flash_attention")
HEAD_DIMS = (64, 80, 128)


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
    second backward kernel (reads the dQ kernel's delta)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    ready = _bwd_inputs("flash_attention_bwd_dkdv", (q, k, v, dout, lse, delta), q, k, v, window, sk_valid)
    if ready is None:
        return _ref.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
    q, k, v, dout, lse, delta = ready
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    BWD_DKDV.launch("flash_attention_bwd_dkdv_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    *_ints(q, k, causal, window, q_offset, sk_valid), stream_ptr(q.device))
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
    reference's public ``flash_attention``, differentiable."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
