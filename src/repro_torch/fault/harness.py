"""Host-side fault injection around the round (counterpart of
``repro.fault.harness``).

The harness runs between rounds: before round r it (1) re-syncs the plane
rows of workers rejoining at r from the anchor — the paper's anchor as the
recovery point — and (2) installs the round's
:class:`~repro_torch.fault.membership.Membership` in
``TrainState.membership``, so the boundary runs masked. Fully-live rounds
install ``None``, so clean rounds run the unmasked boundary.

Under ``AlgoConfig.offload`` the anchor-shaped planes are host-resident
between rounds: the re-sync reads a device copy of the in-flight plane or
of z, restored for it alone, and leaves the state's host planes as they are.

The plane is updated in place: a rejoining worker's rows are copied from
the anchor (no full-plane temporary, as the reference's ``jnp.where``
would make), and the gossip anchor Σ_i mix_i / Σ_i w_i is summed over
column chunks. A per-leaf state (``AlgoConfig.packed=False``) is re-synced
the same way, leaf by leaf, from its per-leaf anchor.

On a worker mesh (:mod:`repro_torch.parallel.sharding`) every rank replays
the same plan, so every rank installs the same (m,) membership and keeps the
same ``records``. A re-sync first drains the rank boundary's pending
collective (:func:`repro_torch.training.drain`: the anchor, or the
avg-rebase average, finished once, and the next boundary starts from it),
then copies the anchor into the rejoining workers' rows that live on this
rank (a sharded anchor's pieces all-gathered over the rank's column slice
first: with fsdp > 1 each rank re-syncs its rows on its columns). Two anchors are sums over all m workers, taken as the rows' f32
partial sums added over the ranks (one blocking all-reduce): the gossip
family's Σ_i mix_i / Σ_i w_i (the drained mix holds the rank's rows) and the
live-mean fallback of the strategies with no anchor (local_sgd, sync_sgd,
powersgd). A per-leaf state takes the same steps leaf by leaf (its drain
finishes the per-leaf in-flight value), and an offloaded state is drained
on device copies of its host planes (:func:`repro_torch.training.drain`):
the anchor read for the re-sync is a device copy, the host planes stay.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.fault.membership import Membership, from_mask
from repro_torch.fault.plan import FaultPlan
from repro_torch.parallel import offload as off
from repro_torch.parallel import sharding
from repro_torch.parallel.packing import Packed, column_chunks, tensors_of, tree_flatten, tree_unflatten
from repro_torch.training import drain


def _row_sum(b: torch.Tensor, scale_fn) -> torch.Tensor:
    """``scale_fn(Σ_i b_i in f32 over a column chunk)`` cast to b's dtype,
    over column chunks of the (m, ...) buffer ``b``; returns a buffer of
    shape ``b.shape[1:]``."""
    rows = b.reshape(b.shape[0], -1)
    out = torch.empty(rows.shape[1], dtype=b.dtype, device=b.device)
    for c in column_chunks(rows):
        out[c] = scale_fn(rows[:, c].float()).to(b.dtype)
    return out.reshape(b.shape[1:])


def _map(fn, x):
    """``fn`` over the buffers of a plane or the leaves of a per-leaf tree."""
    if isinstance(x, Packed):
        return Packed(tuple(fn(b) for b in x.buffers), x.layout)
    leaves, paths = tree_flatten(x)
    return tree_unflatten(paths, [fn(t) for t in leaves])


def _anchor_of(state, mesh=None) -> Optional[Packed]:
    """The recovery point, the unstacked model a rejoining worker resumes
    from: the in-flight collective (the freshest anchor; an avg-rebase
    in-flight's ``avg``; a gossip push collapsed into the mass-weighted
    consensus Σ_i mix_i / Σ_i w_i, summed over the ranks on a ``mesh``),
    else the strategy's anchor z. ``None`` when the strategy carries no
    anchor (local_sgd, sync_sgd, powersgd): the caller falls back to the
    live-worker mean."""
    infl = state.inflight
    if infl is not None and off.is_offloaded(infl):
        infl = off.tree_restore(infl)  # a read-only device copy; the state keeps its host planes
    if infl is not None:
        mix, w = getattr(infl, "mix", None), getattr(infl, "w", None)
        if mix is not None and w is not None:
            wsum = torch.sum(w.float())
            if mesh is not None:
                return _live_mean_over_ranks(mix, None, mesh, scale=wsum)
            return _map(lambda b: _row_sum(b, lambda t: torch.sum(t, dim=0) / wsum), mix)
        return getattr(infl, "avg", infl)
    z = getattr(state.vars, "z", None)
    return off.tree_restore(z) if z is not None and off.is_offloaded(z) else z


def resync_from_anchor(state, resync_mask):
    """Overwrite the plane rows (per leaf: the leaves' rows) of the workers
    flagged in ``resync_mask`` ((m,) bool, on the host) with the anchor, in
    place; other rows are left as they are. Only x is re-synced: the
    worker's optimizer state and the strategy's anchor-shaped state stay.
    Returns the state."""
    mask = np.asarray(resync_mask, bool)
    rows = [int(i) for i in np.nonzero(mask)[0]]
    mesh = sharding.current_mesh()
    lo, hi = (0, len(mask)) if mesh is None else mesh.rows(len(mask))
    if mesh is not None:
        state = drain(state)
    anchor = _anchor_of(state, mesh)
    x = state.x
    if anchor is None:
        # no anchor: recover onto the mean of the workers that were not excluded
        w = (~mask).astype(np.float32)
        w = w / np.sum(w, dtype=np.float32)
        wt = torch.from_numpy(w[lo:hi]).to(tensors_of(x)[0].device)[:, None]
        if mesh is None:
            anchor = _map(lambda b: _row_sum(b, lambda t: torch.sum(t * wt, dim=0)), x)
        else:
            anchor = _live_mean_over_ranks(x, wt, mesh)
    elif isinstance(anchor, sharding.Sharded) and anchor.anchor:  # the pieces over the rank's column slice
        anchor = sharding.anchor_columns(anchor, mesh)
    for b, a in zip(tensors_of(x), tensors_of(anchor)):
        for i in rows:
            if lo <= i < hi:  # the row lives on this rank
                b[i - lo].copy_(a)
    return state


def _live_mean_over_ranks(x, wt: Optional[torch.Tensor], mesh, scale: Optional[torch.Tensor] = None):
    """Σ_i w_i·x_i over all m workers (``wt`` None: Σ_i x_i, then divided by
    ``scale``), cast to each buffer's dtype: the rank's rows' f32 partial
    sums over column chunks (``wt`` their (r, 1) weights), added over the
    ranks by one blocking all-reduce."""
    bufs = tensors_of(x)
    sums = torch.empty(sum(b[0].numel() for b in bufs), dtype=torch.float32, device=bufs[0].device)
    views = torch.split(sums, [b[0].numel() for b in bufs])
    for b, s in zip(bufs, views):
        rows = b.reshape(b.shape[0], -1)
        for c in column_chunks(rows):
            s[c] = torch.sum(rows[:, c].float() if wt is None else rows[:, c].float() * wt, dim=0)
    sharding.all_reduce_(sums, mesh)
    if scale is not None:
        sums.div_(scale)
    it = iter(views)
    return _map(lambda b: next(it).to(b.dtype).reshape(b.shape[1:]), x)


class FaultHarness:
    """Replays a :class:`FaultPlan` against a training run, round by round:

        harness = FaultHarness(plan)
        for r in range(rounds):
            state = harness.before_round(state, r)
            state, metrics = round_step(state, batches)

    ``records`` holds one dict per degraded round."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.records: List[dict] = []

    def membership_at(self, r: int, device="cpu") -> Optional[Membership]:
        """Round r's membership on ``device``: ``None`` when everyone is
        live, a renormalised :class:`Membership` otherwise."""
        mask = self.plan.mask_at(r)
        if mask.all():
            return None
        return from_mask(mask.astype(np.float32), device=device)

    def before_round(self, state, r: int):
        """Apply round r's faults to the state: re-sync rejoining workers from
        the anchor, then install the membership."""
        resync = self.plan.resync_at(r)
        if resync.any():
            state = resync_from_anchor(state, resync)
        mem = self.membership_at(r, device=tensors_of(state.x)[0].device)
        if mem is not None or resync.any():
            mask = self.plan.mask_at(r)
            self.records.append(
                dict(
                    round=r,
                    live=int(mask.sum()),
                    excluded=[int(i) for i in np.nonzero(~mask)[0]],
                    resynced=[int(i) for i in np.nonzero(resync)[0]],
                    reason=self.plan.fault_reason(r),
                )
            )
        return state._replace(membership=mem)

    def fault_reason(self, r: int) -> Optional[str]:
        """Round r's label for the controller's telemetry (None = clean)."""
        return self.plan.fault_reason(r)
