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
QR is ``torch.linalg.qr``, as the reference leaves QR to XLA. Each worker's
product M_i q (and M_iᵀ P) is taken on its own and the workers' products
summed in order 0 .. m−1 in f32, then divided by m (a true division): a
batched product may pick another kernel for another batch size (cuBLAS
does), and the worker sum on ranks is a sum of partial sums. So the packed
path gathers the compressed leaves' factor sums, and the uncompressed
leaves' raw-gradient sums, into one flat f32 buffer a phase.

On a worker mesh (:mod:`repro_torch.parallel.sharding`) the gradient plane
and the error are the rank's rows: each rank sums its rows' products into
the flat buffer and one blocking ``all_reduce_`` adds the ranks' sums before
the division by m; the QR runs replicated on every rank, then the same for
Q' — two all-reduces a step whose size does not grow with n (the factors
and the uncompressed leaves). The error stays the rank's own rows, q is
replicated. On two ranks of one row each this is the one-process step bit
for bit (a two-term sum commutes).

The initial factors: the reference draws each leaf's q with
``jax.random.normal(PRNGKey(hash(shape) % 2**31))``; torch cannot draw
those bits, so the port draws from a ``torch.Generator`` seeded with the
same number. The parity tests carry the reference's q across
(:mod:`repro_torch.interop`).

The per-leaf form (:meth:`PowerSGD.transform_grads`, the legacy
``Algorithm`` and ``AlgoConfig.packed=False``) keeps q as a dict shaped like
the parameters (``None`` at an uncompressed leaf) and the error as a dict
of f32 worker-stacked leaves, as the reference does. It gathers every
leaf's factor sums (an uncompressed leaf's raw gradient sum) into one flat
f32 buffer a phase, as the packed form does, on one device and on a worker
mesh (there two blocking all-reduces a step); both forms take each product
on contiguous operands, so on one device they agree bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import AlgoConfig
from repro_torch.core.algorithms import Algorithm, AlgoVars
from repro_torch.kernels.anchor_mix.ref import row_sum
from repro_torch.parallel import sharding
from repro_torch.parallel.packing import Packed, packed_like, tree_flatten, tree_unflatten
from repro_torch.utils.tree import tree_map


class PowerState(NamedTuple):
    # packed: per leaf (flatten order), (b, r) f32, None for 1-D leaves;
    # per leaf: the same factors in a dict shaped like the parameters
    q: Any
    err: Any  # f32 Packed shadow of the gradient plane, or a dict of f32 (m, ...) leaves

    ROWS = ("err",)  # worker-stacked per leaf (on a worker mesh the rank's rows)


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


def _over_m(acc: torch.Tensor, m: int) -> torch.Tensor:
    """acc / m, a true division by a tensor."""
    return acc / torch.full((), float(m), dtype=torch.float32, device=acc.device)


def _sum_products(M: torch.Tensor, right: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Σ_i M_i·right (or M_iᵀ·right), each worker's product on its own,
    summed in f32 in order 0 .. r−1 over the (r, a, b) rows of M."""
    acc = None
    for i in range(M.shape[0]):
        p = (M[i].T if transpose else M[i]) @ right
        acc = p if acc is None else acc + p
    return acc


def transform_grads(grads, st: PowerState) -> Tuple[Any, PowerState]:
    """The per-leaf compressed step: each leaf of the worker-stacked
    gradients ``grads`` (a nested dict, the rank's rows on a worker mesh) is
    overwritten with its decoded ĝ (every worker's row the same) and its
    error leaf with e' = M − ĝ (zero at an uncompressed leaf), both in
    place; returns them with the new factors. Phase 1's Σ_i M_i q of each
    compressed leaf (Σ_i g_i of a plain one) and phase 2's Σ_i M_iᵀ P are
    each gathered into one flat f32 buffer, summed over the ranks on a mesh
    and divided by m; the QR and the decode run per leaf, replicated. The
    same values on every rank as the one-process step (bit for bit at one
    row a rank: a two-term sum commutes)."""
    mesh = sharding.current_mesh()
    leaves, paths = tree_flatten(grads)
    qs, es = tree_flatten(st.q)[0], tree_flatten(st.err)[0]
    r = leaves[0].shape[0]
    m = r * (1 if mesh is None else mesh.size)
    Ms = [None if q is None else g.float().reshape(r, *_mat_shape(g.shape[1:])) + e.reshape(r, *_mat_shape(g.shape[1:]))
          for g, q, e in zip(leaves, qs, es)]
    firsts = _mean_over_ranks([row_sum(g.reshape(r, -1).float()) if q is None else _sum_products(M, q)
                               for g, q, M in zip(leaves, qs, Ms)], m, mesh)
    Ps = [None if q is None else torch.linalg.qr(f.reshape(-1, q.shape[1]))[0] for q, f in zip(qs, firsts)]
    comp = [(M, P) for M, P in zip(Ms, Ps) if P is not None]
    seconds = iter(_mean_over_ranks([_sum_products(M, P, transpose=True) for M, P in comp], m, mesh)) if comp else iter(())
    new_q = []
    for g, q, e, M, f, P in zip(leaves, qs, es, Ms, firsts, Ps):
        if q is None:  # 1-D / scalar: the mean of the raw gradient, no error
            g.copy_(f.reshape(g.shape[1:]).expand_as(g))
            e.zero_()
            new_q.append(None)
            continue
        Qn = next(seconds).reshape(M.shape[2], P.shape[1])
        ghat = P @ Qn.T
        e.copy_((M - ghat[None]).reshape(e.shape))
        g.copy_(ghat.reshape(g.shape[1:]).expand_as(g))
        new_q.append(Qn)
    return grads, PowerState(q=tree_unflatten(paths, new_q), err=st.err)


def _mean_over_ranks(parts, m: int, mesh):
    """Each part's sum over the ranks (one flat f32 buffer, one blocking
    all-reduce) over m, cut back into the parts."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    if mesh is not None:
        sharding.all_reduce_(flat, mesh)
    return torch.split(_over_m(flat, m), [p.numel() for p in parts])


def transform_grads_packed(pg: Packed, st: PowerState) -> Tuple[Packed, PowerState]:
    """One compressed step over the gradient plane: ``pg`` is overwritten
    with the decoded gradient ĝ (every worker's row the same) and the error
    plane with e' = M − ĝ, both in place; returns them with the new factors.
    On a worker mesh ``pg`` and the error are the rank's rows and the two
    factor sums are all-reduced over the ranks."""
    mesh = sharding.current_mesh()
    r = pg.lead_shape[0]
    m = r * (1 if mesh is None else mesh.size)
    Ms = [g.float() + e for g, e in zip(pg.buffers, st.err.buffers)]  # error-feedback add, one sweep per bucket
    slots = [(slot, st.q[slot.index]) for slot in pg.layout.slots]

    def leaf(slot):
        seg = slice(slot.offset, slot.offset + slot.size)
        a, b = _mat_shape(slot.shape)
        return seg, Ms[slot.bucket][:, seg].reshape(r, a, b).contiguous()

    def mean_over_workers(parts):  # the flat sum of every leaf's part, over the ranks, / m
        return _mean_over_ranks(parts, m, mesh)

    # phase 1: Σ_i M_i q of each compressed leaf and Σ_i g_i of each plain one
    firsts = mean_over_workers([
        row_sum(pg.buffers[slot.bucket][:, slot.offset : slot.offset + slot.size].float()) if q is None
        else _sum_products(leaf(slot)[1], q) for slot, q in slots])
    Ps = [None if q is None else torch.linalg.qr(f.reshape(-1, q.shape[1]))[0]
          for (slot, q), f in zip(slots, firsts)]
    # phase 2: Σ_i M_iᵀ P of each compressed leaf
    comp = [(slot, P) for (slot, q), P in zip(slots, Ps) if q is not None]
    seconds = iter(mean_over_workers([_sum_products(leaf(slot)[1], P, transpose=True) for slot, P in comp])) \
        if comp else iter(())
    new_q = list(st.q)
    ghats = [torch.zeros_like(M) for M in Ms]  # padding lanes stay zero
    compressed = [torch.zeros(M.shape[1], dtype=torch.bool, device=M.device) for M in Ms]
    for (slot, q), f, P in zip(slots, firsts, Ps):
        seg = slice(slot.offset, slot.offset + slot.size)
        if q is None:  # 1-D / scalar: the mean of the raw gradient, no error
            ghats[slot.bucket][:, seg] = f
            continue
        a, b = _mat_shape(slot.shape)
        Qn = next(seconds).reshape(b, P.shape[1])
        new_q[slot.index] = Qn
        compressed[slot.bucket][slot.offset : slot.offset + slot.stride] = True
        ghats[slot.bucket][:, seg] = (P @ Qn.T).reshape(1, a * b)
    for g, e, M, ghat, c in zip(pg.buffers, st.err.buffers, Ms, ghats, compressed):
        e.copy_(torch.where(c, M - ghat, torch.zeros((), device=M.device)))
        g.copy_(ghat)
    return pg, PowerState(q=tuple(new_q), err=st.err)


class PowerSGD(Algorithm):
    """PowerSGD as a legacy single-hook ``Algorithm`` (the reference's
    ``repro.core.powersgd.PowerSGD``), which
    :class:`~repro_torch.core.strategy.PowerSGDStrategy` delegates to: the
    per-leaf hooks and their packed forms."""

    name = "powersgd"
    rank_capable = True

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
