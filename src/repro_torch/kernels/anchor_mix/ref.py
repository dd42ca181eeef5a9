"""Plain PyTorch round boundaries, op for op the reference
``repro.kernels.anchor_mix.ref`` (counterpart; the CUDA kernels in
``csrc/anchor_mix.cu`` compute the same chain): the plain pullback
:func:`anchor_mix` (K5, also its row form), the gossip boundary :func:`gossip_boundary` (K5's
gossip form) and its rank form :func:`gossip_rank`, the fused boundaries (K3,
K4) and their rank form :func:`pullback_rank` (the worker axis over ranks).

The worker mean is summed in float32 in the fixed order i = 0 .. m-1 and
divided by m (a true division, by a tensor: PyTorch divides by a Python
scalar through its rounded reciprocal on the GPU) — the order the CUDA
kernel uses, so the two agree bit for bit. The reference's ``jnp.mean``
leaves the order to XLA.

``weights`` ((m,) f32, zero on dead workers) selects the masked boundary:
dead rows pass through the pullback and the mean is Σ w_i·x_i.
"""
from __future__ import annotations

import torch


def anchor_mix(x: torch.Tensor, z: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 - alpha)·x + alpha·z (paper eq. 4) in float32, cast to x's dtype.
    z has x's shape, or x's shape without its first dim (the row form: one z
    for every row of a worker-stacked x, broadcast)."""
    return ((1.0 - alpha) * x.float() + alpha * z.float()).to(x.dtype)


def gossip_boundary(x, mix, wsafe, live, peff, alpha: float):
    """The push-sum gossip boundary over one bucket, as
    ``repro.core.strategy.GossipPushSumStrategy._packed_boundary`` computes
    it: z = (mix_f32 / wsafe).astype(dtype); x' = K5 toward z on the rows
    with ``live > 0``, x elsewhere; mix' = (Peff @ x'_f32).astype(dtype).
    x, mix: (m, n); wsafe, live: (m,) f32; peff: (m, m) f32. The push sums
    k = 0 .. m-1 in order, one rounded mul and add at a time (the order the
    CUDA kernel uses; XLA's einsum leaves it open). Returns new (x', mix')."""
    z = (mix.float() / wsafe[:, None]).to(x.dtype)
    x_new = torch.where((live > 0)[:, None], anchor_mix(x, z, alpha), x)
    return x_new, push(peff, x_new).to(x.dtype)


def gossip_rank(x, own, recv, held, received, lo: int, peff, wsafe, live, alpha: float, mode: int):
    """K5's gossip rank form on one rank's rows, as the stacked boundary
    (:func:`gossip_boundary`) computes them: x (r, n) the rows ``[lo,
    lo + r)``; own (r, n) their launch-time copy; recv the received rows
    ``received``; ``held`` every row the mix reads (global, ascending).
    mode 0: mix_i = round(Σ_k Peff[lo + i, held_k]·held_k), k in order
    (:func:`push` over Peff's columns of the held rows); mode 1: own holds
    the finished mix; then z = round(mix / wsafe) and x' = K5 toward z on
    the rows with ``live > 0``, x elsewhere, and own ← x'. mode 2 (the
    drain): the mix alone, x unchanged. wsafe, live: (r,) f32; peff (m, m)
    f32. Returns new (x', own') — own' the mix in mode 2."""
    r = x.shape[0]
    if mode == 1:
        mix = own
    else:  # row j from own when it is the rank's, else from the received rows
        rows = torch.stack([own[j - lo] if lo <= j < lo + r else recv[received.index(j)] for j in held])
        cols = torch.as_tensor(held, dtype=torch.long, device=peff.device)
        mix = push(peff[lo : lo + r].index_select(1, cols), rows).to(x.dtype)
    if mode == 2:
        return x, mix
    z = (mix.float() / wsafe[:, None]).to(x.dtype)
    x_new = torch.where((live > 0)[:, None], anchor_mix(x, z, alpha), x)
    return x_new, x_new


def push(peff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Peff @ x in float32 for x (m, n): the products and sums k = 0 .. m−1
    in order, one rounded mul and add at a time (the order the CUDA kernel
    uses; XLA's einsum leaves it open). Returns the (m, n) f32 sums."""
    xf = x.float()
    acc = peff[:, :1] * xf[:1]
    for k in range(1, x.shape[0]):
        acc = acc + peff[:, k : k + 1] * xf[k : k + 1]
    return acc


def row_sum(src: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the rows of ``src`` (r, n), in order 0 .. r−1: a new
    tensor also for one f32 row (never a view of ``src``)."""
    acc = src[0].to(torch.float32, copy=True)
    for i in range(1, src.shape[0]):
        acc = acc + src[i].float()
    return acc


def _over_m(acc: torch.Tensor, m: int) -> torch.Tensor:
    """acc / m, a true division by a tensor (the kernels' __fdiv_rn)."""
    return acc / torch.full((), float(m), dtype=torch.float32, device=acc.device)


def worker_mean(src: torch.Tensor, weights=None) -> torch.Tensor:
    """f32 mean over the rows of ``src`` (m, n) in order, or the weighted sum."""
    m = src.shape[0]
    if weights is None:
        return _over_m(row_sum(src), m)
    w = weights.float()
    acc = src[0].float() * w[0]
    for i in range(1, m):
        acc = acc + src[i].float() * w[i]
    return acc


def pullback_mean(x, z, alpha: float, mean_pre: bool = False, weights=None):
    """Eq. (4) + worker mean. x: (m, n), z: (n,). Returns new (x_new, mean);
    the mean is of the pulled-back rows, or of x when ``mean_pre``."""
    xf = x.float()
    zf = z.float()
    x_new = ((1.0 - alpha) * xf + alpha * zf[None]).to(x.dtype)
    if weights is not None:
        x_new = torch.where((weights.float() > 0)[:, None], x_new, x)
    src = x if mean_pre else x_new
    return x_new, worker_mean(src, weights).to(x.dtype)


def pullback_mean_momentum(x, z, v, alpha: float, beta: float, weights=None):
    """Eq. (4) + eqs. (10)-(11). x: (m, n); z (consumed anchor), v (anchor
    momentum): (n,). Returns new (x_new, z_next, v_new)."""
    x_new, mean = pullback_mean(x, z, alpha, weights=weights)
    zf = z.float()
    v_new = (beta * v.float() + (mean.float() - zf)).to(v.dtype)
    z_next = (zf + v_new.float()).to(z.dtype)
    return x_new, z_next, v_new


def pullback_rank(x, z, v, s, m: int, alpha: float, beta, finish, weights=None, mean_pre: bool = False):
    """K3/K4's rank form: the boundary of one rank's rows ``x`` (r, n) when
    the worker axis is spread over ranks. With ``finish``, first the tail of
    K3/K4 on ``s``, the f32 worker sum of the last boundary over all m
    workers: mean = round(s / m) (``finish == 2``: s is a weighted sum and
    mean = round(s)); K3 (``v`` given): v' = round(β·v + (mean − z)), z' =
    round(z + v'); K4: z' = mean. Then the rows pulled back toward z' (eq. 4;
    toward z without ``finish``) and their f32 partial sum in row order
    (None for r = 0): with ``weights`` ((r,) f32, the rows' slice of a
    membership) dead rows keep x and the sum is Σ w_i·x_i; with
    ``mean_pre`` the sum is of the pre-pullback rows. Returns new (x_new,
    z', v' or None, partial)."""
    v_new = None
    if finish:
        # a buffer of its own: s is overwritten with the rows' partial sum
        mean = s.to(z.dtype, copy=True) if finish == 2 else _over_m(s, m).to(z.dtype)
        if v is None:
            z_next = mean
        else:
            zf = z.float()
            v_new = (beta * v.float() + (mean.float() - zf)).to(v.dtype)
            z_next = (zf + v_new.float()).to(z.dtype)
    else:
        z_next = z
    x_new = ((1.0 - alpha) * x.float() + alpha * z_next.float()[None]).to(x.dtype)
    if weights is not None:
        x_new = torch.where((weights.float() > 0)[:, None], x_new, x)
    if not x.shape[0]:
        return x_new, z_next, v_new, None
    src = x if mean_pre else x_new
    return x_new, z_next, v_new, (row_sum(src) if weights is None else worker_mean(src, weights))
