"""Plain PyTorch Mamba2 SSD scan [arXiv:2405.21060 as used by Zamba2,
arXiv:2411.15242], op for op the reference ``repro.kernels.ssd_scan.ref``.

Per batch b, head h, head_dim p, state n:

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t k-outer x_t
    y_t = C_t · s_t + D_h * x_t

Shapes: x (B, S, H, P); dt (B, S, H); A (H,) with A < 0; B, C (B, S, G, N)
with G | H (grouped like Mamba2's n_groups); D (H,). Returns (y (B, S, H, P)
in x's dtype, final state (B, H, P, N) in f32).

* :func:`ssd_reference` — a loop over time in f32 (ground truth).
* :func:`ssd_chunked` — the chunked SSD form the kernel computes: dense
  products inside a chunk, the state carried across chunks in f32. Torch
  autograd through it is the plain version of the backward kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def _expand_groups(mat: torch.Tensor, h: int) -> torch.Tensor:
    g = mat.shape[2]
    return torch.repeat_interleave(mat, h // g, dim=2)  # (B, S, H, N)


def ssd_reference(x, dt, A, B, C, D) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B.to(F32), h)
    Ch = _expand_groups(C.to(F32), h)
    xf = x.to(F32)
    dtf = dt.to(F32)
    state = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dtf[:, t]
        decay = torch.exp(dtt * A)[..., None, None]  # (B, H, 1, 1)
        upd = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtt[..., None], Bh[:, t])
        state = decay * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((b, 0, h, p), dtype=F32, device=x.device)
    y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:  # zero steps: dt = 0 is an identity decay and adds nothing
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    # cast, then repeat to the heads (the reference repeats, then casts: the
    # same values; the gradient then sums a group's heads in f32 and rounds
    # once, as the backward kernel's wrapper does)
    Bh = _expand_groups(B.to(F32), h)
    Ch = _expand_groups(C.to(F32), h)
    xf = x.to(F32)
    dtf = dt.to(F32)

    # to chunks: (B, nc, L, H, ...)
    xc = xf.reshape(b, nc, chunk, h, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc = Bh.reshape(b, nc, chunk, h, n)
    Cc = Ch.reshape(b, nc, chunk, h, n)

    dA = dtc * A  # (B, nc, L, H)
    cum = torch.cumsum(dA, dim=2)  # inclusive along the chunk
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk: M_lm = exp(cum_l - cum_m) for l >= m
    li = cum[:, :, :, None, :]  # (B, nc, L, 1, H)
    lj = cum[:, :, None, :, :]  # (B, nc, 1, L, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # mask the exponent BEFORE exp: masked entries would overflow to +inf and
    # poison the backward pass (inf * 0 cotangent = NaN)
    M = torch.exp(torch.where(mask[None, None, :, :, None], li - lj, torch.full((), -1e9, dtype=F32, device=x.device)))
    CB = torch.einsum("bclhn,bcmhn->bclmh", Cc, Bc)  # (B, nc, L, L, H)
    xbar = xc * dtc[..., None]
    y_intra = torch.einsum("bclmh,bclmh,bcmhp->bclhp", CB, M, xbar)

    # chunk summary state: S_c = sum_m exp(total - cum_m) B_m^T xbar_m -> (B, nc, H, P, N)
    decay_to_end = torch.exp(total[:, :, None] - cum)  # (B, nc, L, H)
    S_c = torch.einsum("bclh,bclhn,bclhp->bchpn", decay_to_end, Bc, xbar)

    # inter-chunk recurrence over the chunk states
    state = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    prevs = []
    for ci in range(nc):
        prevs.append(state)  # the state entering chunk ci
        state = torch.exp(total[:, ci])[..., None, None] * state + S_c[:, ci]
    prev = torch.stack(prevs, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: y_l += exp(cum_l) * C_l · S_prev
    y_inter = torch.einsum("bclh,bclhn,bchpn->bclhp", torch.exp(cum), Cc, prev)

    y = (y_intra + y_inter).reshape(b, sp, h, p) + xf * D[None, None, :, None]
    return y[:, :s].to(x.dtype), state
