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
  plain version of the backward kernels.
* :func:`wkv_states`, :func:`wkv_dstates` — the plain versions of each
  direction's first kernel: the state entering every chunk (and the final
  state) as ``wkv_chunked`` forms them, and the cotangent of the state
  leaving every chunk.
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

    # jnp.maximum's gradient at a tie (w = 1e-30) is one half, as torch.maximum's
    # (clamp_min's is one)
    logw = torch.log(torch.maximum(wc, torch.tensor(1e-30, dtype=F32, device=wc.device)))
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


def _chunk_decays(w, chunk):
    """w (B, S, H, N) padded with ones to whole chunks -> (cum (B, nc, L, H,
    N), cum_excl, total (B, nc, H, N)) as ``wkv_chunked`` forms them."""
    b, s, h, n = w.shape
    pad = (-s) % chunk
    wf = torch.nn.functional.pad(w.to(F32), (0, 0, 0, 0, 0, pad), value=1.0) if pad else w.to(F32)
    wc = wf.reshape(b, -1, chunk, h, n)
    logw = torch.log(torch.maximum(wc, torch.tensor(1e-30, dtype=F32, device=w.device)))
    cum = torch.cumsum(logw, dim=2)
    return cum, cum - logw, cum[:, :, -1]


def _chunks(x, chunk):
    """(B, S, H, N) zero-padded to whole chunks, as (B, nc, L, H, N) in f32."""
    pad = (-x.shape[1]) % chunk
    x = torch.nn.functional.pad(x.to(F32), (0, 0, 0, 0, 0, pad)) if pad else x.to(F32)
    return x.reshape(x.shape[0], -1, chunk, *x.shape[2:])


def wkv_states(k, v, w, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the state entering each chunk (B·H, nc, N, P) f32, the final state
    (B, H, N, P) f32): the chunk summaries and their recurrence, as
    ``wkv_chunked``'s loop forms them (the plain version of the forward's
    first kernel)."""
    b, _, h, n = k.shape
    p = v.shape[-1]
    cum, _, total = _chunk_decays(w, chunk)
    S_c = torch.einsum("bclhn,bclhn,bclhp->bchnp", torch.exp(total[:, :, None] - cum), _chunks(k, chunk),
                       _chunks(v, chunk))
    state = torch.zeros((b, h, n, p), dtype=F32, device=k.device)
    prevs = []
    for ci in range(S_c.shape[1]):
        prevs.append(state)
        state = torch.exp(total[:, ci])[..., None] * state + S_c[:, ci]
    return torch.stack(prevs, dim=2).reshape(b * h, len(prevs), n, p), state


def wkv_dstates(r, w, dy, dstate=None, chunk: int = 32) -> torch.Tensor:
    """The cotangent of the state leaving each chunk (B·H, nc, N, P) f32,
    from dy (B, S, H, P) and the final state's cotangent (None for zero),
    backward over the chunks: D[nc-1] = dstate, D[c-1] = e^total[c] D[c] +
    sum_l (r[l] e^cum_excl[l])^T dy[l] (the plain version of the backward's
    first kernel)."""
    b, _, h, n = r.shape
    p = dy.shape[-1]
    _, cum_excl, total = _chunk_decays(w, chunk)
    dS_c = torch.einsum("bclhn,bclhn,bclhp->bchnp", _chunks(r, chunk), torch.exp(cum_excl), _chunks(dy, chunk))
    D = torch.zeros((b, h, n, p), dtype=F32, device=r.device) if dstate is None else dstate.to(F32)
    outs = []
    for ci in reversed(range(dS_c.shape[1])):
        outs.append(D)
        D = torch.exp(total[:, ci])[..., None] * D + dS_c[:, ci]
    return torch.stack(outs[::-1], dim=2).reshape(b * h, len(outs), n, p)
