"""Plain PyTorch round boundaries, op for op the reference
``repro.kernels.anchor_mix.ref`` (counterpart; the CUDA kernels in
``csrc/anchor_mix.cu`` compute the same chain): the plain pullback
:func:`anchor_mix` (K5, also its row form), the gossip boundary :func:`gossip_boundary` (K5's
gossip form) and the fused boundaries (K3, K4).

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


def push(peff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Peff @ x in float32 for x (m, n): the products and sums k = 0 .. m−1
    in order, one rounded mul and add at a time (the order the CUDA kernel
    uses; XLA's einsum leaves it open). Returns the (m, n) f32 sums."""
    xf = x.float()
    acc = peff[:, :1] * xf[:1]
    for k in range(1, x.shape[0]):
        acc = acc + peff[:, k : k + 1] * xf[k : k + 1]
    return acc


def worker_mean(src: torch.Tensor, weights=None) -> torch.Tensor:
    """f32 mean over the rows of ``src`` (m, n) in order, or the weighted sum."""
    m = src.shape[0]
    if weights is None:
        acc = src[0].float()
        for i in range(1, m):
            acc = acc + src[i].float()
        return acc / torch.full((), float(m), dtype=torch.float32, device=src.device)
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
