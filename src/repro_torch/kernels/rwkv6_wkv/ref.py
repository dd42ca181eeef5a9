"""Plain PyTorch RWKV-6 "Finch" WKV recurrence [arXiv:2404.05892], op for op
the reference ``repro.kernels.rwkv6_wkv.ref``.

Per head with key-dim n and value-dim p, data-dependent per-channel decay
w_t ∈ (0,1)^n and bonus u ∈ R^n:

    y_t = r_t · (diag(u) k_tᵀ v_t + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

Shapes: r, k, w (B, S, H, N); v (B, S, H, P); u (H, N). Returns (y (B, S, H, P)
in r's dtype, final state (B, H, N, P) in f32).

* :func:`wkv_reference` — a loop over time in f32 (ground truth).
* :func:`wkv_chunked` — the chunked form the kernel computes: cumulative
  log-decays inside a chunk turn the recurrence into dense products, with
  the state carried across chunks in f32. Torch autograd through it is the
  plain version of the backward kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def wkv_reference(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, n = r.shape
    p = v.shape[-1]
    rf, kf, vf, wf = (t.to(F32) for t in (r, k, v, w))
    uf = u.to(F32)
    state = torch.zeros((b, h, n, p), dtype=F32, device=r.device)
    ys = []
    for t in range(s):
        kv = torch.einsum("bhn,bhp->bhnp", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", rf[:, t], uf[None, :, :, None] * kv + state))
        state = wf[:, t][..., None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros((b, 0, h, p), dtype=F32, device=r.device)
    return y.to(r.dtype), state


def wkv_chunked(r, k, v, w, u, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, n = r.shape
    p = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        zr = (0, 0, 0, 0, 0, pad)  # the sequence axis, from the last dim backwards
        r = torch.nn.functional.pad(r, zr)
        k = torch.nn.functional.pad(k, zr)
        v = torch.nn.functional.pad(v, zr)
        w = torch.nn.functional.pad(w, zr, value=1.0)  # identity decay in padding
    sp = r.shape[1]
    nc = sp // chunk
    rf, kf, vf, wf = (t.to(F32) for t in (r, k, v, w))
    uf = u.to(F32)

    rc = rf.reshape(b, nc, chunk, h, n)
    kc = kf.reshape(b, nc, chunk, h, n)
    vc = vf.reshape(b, nc, chunk, h, p)
    wc = wf.reshape(b, nc, chunk, h, n)

    logw = torch.log(torch.clamp_min(wc, 1e-30))
    cum = torch.cumsum(logw, dim=2)  # (B, nc, L, H, N) inclusive
    total = cum[:, :, -1]  # (B, nc, H, N)
    # y_i reads S_{i-1} = sum_{j<i} exp(cum_{i-1} - cum_j) k_jᵀ v_j; cum_excl_i
    # = cum_i - logw_i is the cumsum exclusive of i
    cum_excl = cum - logw
    li = cum_excl[:, :, :, None]  # (B, nc, L, 1, H, N)
    lj = cum[:, :, None, :, :]  # (B, nc, 1, L, H, N)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    # mask the exponent BEFORE exp: masked entries would overflow to +inf and
    # poison the backward pass (inf * 0 cotangent = NaN)
    diff = torch.where(strict[None, None, :, :, None, None], li - lj, torch.full((), -1e9, dtype=F32, device=r.device))
    decay = torch.exp(diff)
    # scores: A_ij = sum_n r_in * decay_ijn * k_jn (strictly lower triangular)
    A = torch.einsum("bclhn,bclmhn,bcmhn->bclmh", rc, decay, kc)
    # bonus diagonal: y_i += (r_i ⊙ u ⊙ k_i) · v_i
    diag = torch.einsum("bclhn,hn,bclhn->bclh", rc, uf, kc)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", A, vc) + diag[..., None] * vc

    # chunk summary: S_chunk = sum_j exp(total - cum_j) k_jᵀ v_j
    dte = torch.exp(total[:, :, None] - cum)  # (B, nc, L, H, N)
    S_c = torch.einsum("bclhn,bclhn,bclhp->bchnp", dte, kc, vc)

    state = torch.zeros((b, h, n, p), dtype=F32, device=r.device)
    prevs = []
    for ci in range(nc):
        prevs.append(state)
        state = torch.exp(total[:, ci])[..., None] * state + S_c[:, ci]
    prev = torch.stack(prevs, dim=1)  # (B, nc, H, N, P)

    # inter-chunk: y_i += r_i · diag(exp(cum_excl_i)) S_prev
    y_inter = torch.einsum("bclhn,bchnp->bclhp", rc * torch.exp(cum_excl), prev)

    y = (y_intra + y_inter).reshape(b, sp, h, p)
    return y[:, :s].to(r.dtype), state
