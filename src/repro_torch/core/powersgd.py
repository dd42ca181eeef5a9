"""PowerSGD [5]: rank-r gradient compression with error feedback, on the
packed gradient plane (counterpart of the packed path of
``repro.core.powersgd``).

Per leaf of two or more dimensions, reshaped to (a, b), with the error
feedback added, M = g + e: one power-iteration step
P = QR(mean_i(M_i Q)), Q' = mean_i(M_iᵀ P), decoded ĝ = P Q'ᵀ, the same
for every worker; e' = M − ĝ. Leaves of one dimension (and scalars) take
the plain worker mean of the raw gradient and carry no error. Runs every
step (τ = 1).

The factors are per-leaf work (the compression itself); the error-feedback
add and the error update are one sweep per bucket of the f32 error plane.
QR is ``torch.linalg.qr``, as the reference leaves QR to XLA.

The initial factors: the reference draws each leaf's q with
``jax.random.normal(PRNGKey(hash(shape) % 2**31))``; torch cannot draw
those bits, so the port draws from a ``torch.Generator`` seeded with the
same number. The parity tests carry the reference's q across
(:mod:`repro_torch.interop`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel.packing import Packed, packed_like


class PowerState(NamedTuple):
    q: Tuple[Optional[torch.Tensor], ...]  # per leaf (flatten order): (b, r) f32, None for 1-D leaves
    err: Any  # f32 Packed shadow of the worker-stacked gradient plane


def _mat_shape(shape) -> Tuple[int, int]:
    b = 1
    for s in shape[1:]:
        b *= s
    return shape[0], b


def init_q(layout, rank: int, device) -> Tuple[Optional[torch.Tensor], ...]:
    """Each ≥ 2-D leaf's (b, min(r, a, b)) f32 starting factor, from a
    generator seeded ``hash(shape) % 2**31`` (the reference's seed)."""

    def q_for(shape):
        if len(shape) < 2:
            return None
        a, b = _mat_shape(shape)
        gen = torch.Generator().manual_seed(hash(tuple(shape)) % (2**31))
        return torch.randn((b, min(rank, a, b)), generator=gen, dtype=torch.float32).to(device)

    return tuple(q_for(s.shape) for s in layout.slots)


def init_state(px: Packed, rank: int) -> PowerState:
    return PowerState(q=init_q(px.layout, rank, px.buffers[0].device), err=packed_like(px, 0.0, dtype=torch.float32))


def transform_grads_packed(pg: Packed, st: PowerState) -> Tuple[Packed, PowerState]:
    """One compressed step over the gradient plane: ``pg`` is overwritten
    with the decoded gradient ĝ (every worker's row the same) and the error
    plane with e' = M − ĝ, both in place; returns them with the new factors."""
    m = pg.lead_shape[0]
    new_q = list(st.q)
    for bi, (g, e) in enumerate(zip(pg.buffers, st.err.buffers)):
        M = g.float() + e  # error-feedback add, one sweep per bucket
        ghat = torch.zeros_like(M)  # padding lanes stay zero
        compressed = torch.zeros(M.shape[1], dtype=torch.bool, device=M.device)
        for slot in pg.layout.slots:
            if slot.bucket != bi:
                continue
            seg = slice(slot.offset, slot.offset + slot.size)
            q = st.q[slot.index]
            if q is None:  # 1-D / scalar: the mean of the raw gradient, no error
                ghat[:, seg] = torch.mean(g[:, seg].float(), dim=0)
                continue
            compressed[slot.offset : slot.offset + slot.stride] = True
            a, b = _mat_shape(slot.shape)
            Mi = M[:, seg].reshape(m, a, b)
            P = torch.mean(Mi @ q, dim=0)  # (a, r): the mean of rank-r factors
            P, _ = torch.linalg.qr(P)
            Qn = torch.mean(torch.einsum("mab,ar->mbr", Mi, P), dim=0)  # (b, r)
            ghat[:, seg] = (P @ Qn.T).reshape(1, a * b)
            new_q[slot.index] = Qn
        e.copy_(torch.where(compressed, M - ghat, torch.zeros((), device=M.device)))
        g.copy_(ghat)
    return pg, PowerState(q=tuple(new_q), err=st.err)
