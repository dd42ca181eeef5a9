"""Flash attention — plain PyTorch versions (counterpart of
``repro.kernels.flash_attention.ref`` and of the Pallas body
``repro.kernels.flash_attention.kernel._fa_kernel``).

Every function takes q ``(B, Sq, H, D)`` and k, v ``(B, Sk, Hkv, D)`` with H
a multiple of Hkv (GQA: q-head h reads kv-head ``h // (H // Hkv)``), a
pre-scaled q, and ``q_offset``, the absolute position of q[:, 0].

* :func:`flash_attention_fwd` — the plain version of the forward kernel: the
  Pallas body op for op (f32 scores; the masks ``k < sk_valid``, causal and
  window; ``safe_m`` for rows with every key masked; p rounded to v's dtype
  before P·V; f32 accumulation; division by ``max(l, 1e-30)``), walking the
  keys in blocks of 128, the bf16 CUDA kernel's and the Pallas body's own
  (64 at head_dim 192, the kernel's block there), so p is rounded at the
  same running max. It also returns the per-row f32
  log-sum-exp the backward kernel needs (``+inf`` for a fully masked row).
* :func:`flash_attention_bwd` — the plain version of the backward kernels
  (FlashAttention-2): p recomputed in f32 from the log-sum-exp and **not**
  rounded, Δ = rowsum(dO∘O), dV = pᵀdO, dS = p∘(dO·Vᵀ − Δ), dQ = dS·K,
  dK = dSᵀ·Q, each rounded once to its input's dtype. (The bf16 kernels
  round P and dS to bf16 as tensor-core operands; they are held against
  this unrounded version within the stated bounds.)
* :func:`dkdv_sum` — the plain version of the bf16 dK/dV pass's split sum:
  the f32 partials added in split order, rounded once.
* :func:`mha_reference` and :func:`chunked_mha` — the reference's oracles,
  op for op (exact masked softmax; KV-block online softmax).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32
NEG_INF = float("-inf")
BLOCK_K = 128  # keys per block of the online softmax: the bf16 kernel's and the Pallas body's


def block_k_for(d: int) -> int:
    """Keys per block of the bf16 forward kernel at head_dim ``d``:
    :data:`BLOCK_K`, or 64 above 128 (at 192 the kernel's shared memory holds
    Q and a ring of 64-key K and V tiles)."""
    return BLOCK_K if d <= 128 else 64


def visible(sq: int, sk: int, *, causal: bool, window: Optional[int], q_offset: int,
            sk_valid: Optional[int] = None, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query attends to."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = k_pos < (sk if sk_valid is None else sk_valid)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > (q_pos - window))
    return mask


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    b, sq, h, d = q.shape
    return q.reshape(b, sq, hkv, h // hkv, d).to(F32)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                        sk_valid: Optional[int] = None, block_k: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32). The
    online softmax walks ``block_k`` keys at a time (default
    :func:`block_k_for` of the head dim), as the kernel does, so p is
    rounded to v's dtype at the same scale in both."""
    block_k = block_k or block_k_for(q.shape[-1])
    b, sq, h, _ = q.shape
    k, v = _valid(k, sk_valid), _valid(v, sk_valid)
    sk, hkv = k.shape[1], k.shape[2]
    g, dv = h // hkv, v.shape[-1]
    mask = visible(sq, sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    qg = _grouped(q, hkv)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), device=q.device)
    for k0 in range(0, sk, block_k):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, k0 : k0 + block_k].to(F32))
        s = torch.where(mask[:, k0 : k0 + block_k], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.exp(s - safe_m[..., None])
        corr = torch.exp(m - safe_m)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(F32), v[:, k0 : k0 + block_k].to(F32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
    lse = torch.where(m == NEG_INF, float("inf"), m + torch.log(l)).reshape(b, h, sq)
    return out, lse


def _valid(t: torch.Tensor, sk_valid: Optional[int]) -> torch.Tensor:
    """Keys at or past ``sk_valid`` do not take part (their contents, NaN
    included, never reach a product), as in the kernel, which reads them as
    zeros and masks them."""
    return t if sk_valid is None else t[:, :sk_valid]


def _dscores(q, k, v, lse, dout, delta, *, causal, window, q_offset):
    """p (unrounded f32, from lse) and dS = p∘(dO·Vᵀ − Δ), each (b, hkv, g, sq, sk)."""
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    mask = visible(sq, sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, hkv), k.to(F32))
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, h // hkv, sq)[..., None]), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(dout, hkv), v.to(F32))
    return p, p * (dp - delta.reshape(b, hkv, h // hkv, sq)[..., None])


def flash_attention_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0, sk_valid: Optional[int] = None):
    """(dq, delta): the dQ kernel's outputs, Δ = rowsum(dO∘O) (B, H, Sq) f32."""
    b, sq, h, d = q.shape
    delta = (dout.to(F32) * out.to(F32)).sum(dim=-1).transpose(1, 2)
    k, v = _valid(k, sk_valid), _valid(v, sk_valid)
    _, ds = _dscores(q, k, v, lse, dout, delta, causal=causal, window=window, q_offset=q_offset)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(F32)).reshape(b, sq, h, d)
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, *, causal: bool = True, window: Optional[int] = None,
                             q_offset: int = 0, sk_valid: Optional[int] = None):
    """(dk, dv): the dK/dV kernel's outputs, summed over each kv-head's group."""
    sk, hkv = k.shape[1], k.shape[2]
    p, ds = _dscores(q, _valid(k, sk_valid), _valid(v, sk_valid), lse, dout, delta, causal=causal, window=window,
                     q_offset=q_offset)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, _grouped(dout, hkv))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, hkv))
    pad = (0, 0, 0, 0, 0, sk - dk.shape[1])  # the masked keys' gradients are zero
    return torch.nn.functional.pad(dk, pad).to(k.dtype), torch.nn.functional.pad(dv, pad).to(v.dtype)


def dkdv_sum(part: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in ``dtype`` from f32 partials (2, n, B, Sk, Hkv, D): each
    the sum over the n splits in split order, rounded once (the split sum
    kernel's plain version)."""
    acc = part[:, 0].clone()
    for i in range(1, part.shape[1]):
        acc += part[:, i]
    return acc[0].to(dtype), acc[1].to(dtype)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, sk_valid: Optional[int] = None):
    """Gradients (dq, dk, dv) of the unrounded f32 attention, from the saved
    output and log-sum-exp."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw)
    return (dq, *flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw))


def mha_reference(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0):
    """Exact masked softmax, f32 (``ref.py::mha_reference``)."""
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, hkv), k.to(F32))
    mask = visible(sq, sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def chunked_mha(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                block_q: int = 1024, block_k: int = 1024):
    """Q/KV block-tiled online softmax in plain ops (``ref.py::chunked_mha``:
    zero-padded blocks, ``k_pos < sk`` mask, the same update order)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, dv = h // hkv, v.shape[-1]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    pad_q, pad_k = (-sq) % block_q, (-sk) % block_k
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k
    qb = qp.reshape(b, nq, block_q, hkv, g, d).to(F32)
    kb = kp.reshape(b, nk, block_k, hkv, d).to(F32)
    vb = vp.reshape(b, nk, block_k, hkv, dv).to(F32)
    dev = q.device
    blocks = []
    for qi in range(nq):
        q_pos = q_offset + qi * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, hkv, g, block_q, dv), dtype=F32, device=dev)
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, block_q), device=dev)
        for ki in range(nk):
            k_pos = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb[:, qi], kb[:, ki])
            mask = (k_pos < sk)[None, :].expand(block_q, block_k)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > (q_pos[:, None] - window))
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - safe_m[..., None])
            corr = torch.exp(m - safe_m)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb[:, ki])
            m = m_new
        blocks.append(acc / torch.clamp(l[..., None], min=1e-30))  # (b, hkv, g, block_q, dv)
    out = torch.stack(blocks, dim=1)  # (b, nq, hkv, g, block_q, dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * block_q, h, dv)
    return out[:, :sq].to(q.dtype)
