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

The per-leaf form (:meth:`PowerSGD.transform_grads`, the legacy
``Algorithm`` and ``AlgoConfig.packed=False``) keeps q as a dict shaped like
the parameters (``None`` at an uncompressed leaf) and the error as a dict
of f32 worker-stacked leaves, as the reference does. Both forms run each
leaf through :func:`_compress_leaf` and :func:`_plain_mean` on contiguous
operands, so on one device they agree bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.core.algorithms import Algorithm, AlgoVars
from repro_torch.parallel.packing import Packed, packed_like
from repro_torch.utils.tree import tree_map


class PowerState(NamedTuple):
    # packed: per leaf (flatten order), (b, r) f32, None for 1-D leaves;
    # per leaf: the same factors in a dict shaped like the parameters
    q: Any
    err: Any  # f32 Packed shadow of the gradient plane, or a dict of f32 (m, ...) leaves


def _mat_shape(shape) -> Tuple[int, int]:
    b = 1
    for s in shape[1:]:
        b *= s
    return shape[0], b


def _q_for(shape, rank: int, device) -> Optional[torch.Tensor]:
    """A ≥ 2-D leaf's (b, min(r, a, b)) f32 starting factor, from a
    generator seeded ``hash(shape) % 2**31`` (the reference's seed)."""
    if len(shape) < 2:
        return None
    a, b = _mat_shape(shape)
    gen = torch.Generator().manual_seed(hash(tuple(shape)) % (2**31))
    return torch.randn((b, min(rank, a, b)), generator=gen, dtype=torch.float32).to(device)


def init_q(layout, rank: int, device) -> Tuple[Optional[torch.Tensor], ...]:
    """Each leaf's starting factor, in the layout's leaf order."""
    return tuple(_q_for(s.shape, rank, device) for s in layout.slots)


def init_state(px: Packed, rank: int) -> PowerState:
    return PowerState(q=init_q(px.layout, rank, px.buffers[0].device), err=packed_like(px, 0.0, dtype=torch.float32))


def init_state_tree(x, rank: int) -> PowerState:
    """The per-leaf state of worker-stacked params ``x`` (a nested dict)."""
    return PowerState(q=tree_map(lambda t: _q_for(tuple(t.shape[1:]), rank, t.device), x),
                      err=tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), x))


def _plain_mean(g: torch.Tensor) -> torch.Tensor:
    """An uncompressed leaf's f32 worker mean ((m, size) → (size,))."""
    return torch.mean(g.float().contiguous(), dim=0)


def _compress_leaf(M: torch.Tensor, q: torch.Tensor):
    """One power-iteration step on a contiguous (m, a, b) f32 leaf M = g + e:
    P = QR(mean_i(M_i q)), Q' = mean_i(M_iᵀ P), ĝ = P Q'ᵀ. Returns (ĝ (a, b),
    Q')."""
    P = torch.mean(M @ q, dim=0)  # (a, r): the mean of rank-r factors
    P, _ = torch.linalg.qr(P)
    Qn = torch.mean(torch.einsum("mab,ar->mbr", M, P), dim=0)  # (b, r)
    return P @ Qn.T, Qn


def transform_grads(grads, st: PowerState) -> Tuple[Any, PowerState]:
    """The per-leaf compressed step: each leaf of the worker-stacked
    gradients ``grads`` (a nested dict) is overwritten with its decoded ĝ
    (every worker's row the same) and its error leaf with e' = M − ĝ (zero
    at an uncompressed leaf), both in place; returns them with the new
    factors."""

    def leaf(g, q, e):
        m = g.shape[0]
        if q is None:  # 1-D / scalar: the mean of the raw gradient, no error
            g.copy_(_plain_mean(g.reshape(m, -1)).reshape(g.shape[1:]).expand_as(g))
            e.zero_()
            return q
        a, b = _mat_shape(g.shape[1:])
        M = g.float().reshape(m, a, b) + e.reshape(m, a, b)
        ghat, Qn = _compress_leaf(M, q)
        e.copy_((M - ghat[None]).reshape(e.shape))
        g.copy_(ghat.reshape(g.shape[1:]).expand_as(g))
        return Qn

    return grads, PowerState(q=tree_map(leaf, grads, st.q, st.err), err=st.err)


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
                ghat[:, seg] = _plain_mean(g[:, seg])
                continue
            compressed[slot.offset : slot.offset + slot.stride] = True
            a, b = _mat_shape(slot.shape)
            gh, new_q[slot.index] = _compress_leaf(M[:, seg].reshape(m, a, b).contiguous(), q)
            ghat[:, seg] = gh.reshape(1, a * b)
        e.copy_(torch.where(compressed, M - ghat, torch.zeros((), device=M.device)))
        g.copy_(ghat)
    return pg, PowerState(q=tuple(new_q), err=st.err)


class PowerSGD(Algorithm):
    """PowerSGD as a legacy single-hook ``Algorithm`` (the reference's
    ``repro.core.powersgd.PowerSGD``), which
    :class:`~repro_torch.core.strategy.PowerSGDStrategy` delegates to: the
    per-leaf hooks and their packed forms."""

    name = "powersgd"

    def __init__(self, cfg: AlgoConfig):
        super().__init__(cfg)
        self.tau = 1
        self.rank = cfg.powersgd_rank

    def init_vars(self, x_stacked) -> AlgoVars:
        return AlgoVars(extra=init_state_tree(x_stacked, self.rank))

    def init_vars_packed(self, px: Packed) -> AlgoVars:
        return AlgoVars(extra=init_state(px, self.rank))

    def transform_grads(self, grads, vars: AlgoVars):
        grads, st = transform_grads(grads, vars.extra)
        return grads, AlgoVars(z=vars.z, v=vars.v, extra=st)

    def transform_grads_packed(self, pg: Packed, vars: AlgoVars):
        pg, st = transform_grads_packed(pg, vars.extra)
        return pg, AlgoVars(z=vars.z, v=vars.v, extra=st)
