"""Host-side fault injection around the round (counterpart of
``repro.fault.harness``).

The harness runs between rounds: before round r it (1) re-syncs the plane
rows of workers rejoining at r from the anchor — the paper's anchor as the
recovery point — and (2) installs the round's
:class:`~repro_torch.fault.membership.Membership` in
``TrainState.membership``, so the boundary runs masked. Fully-live rounds
install ``None``, so clean rounds run the unmasked boundary.

The plane is updated in place: a rejoining worker's rows are copied from
the anchor (no full-plane temporary, as the reference's ``jnp.where``
would make), and the gossip anchor Σ_i mix_i / Σ_i w_i is summed over
column chunks.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.fault.membership import Membership, from_mask
from repro_torch.fault.plan import FaultPlan
from repro_torch.parallel.packing import Packed

# columns a chunk of an anchor sum takes: its f32 temporary stays near
# 2^26 elements whatever the plane's size
_CHUNK_ELEMS = 1 << 26


def _row_sum(b: torch.Tensor, scale_fn) -> torch.Tensor:
    """``scale_fn(Σ_i b_i in f32 over a column chunk)`` cast to b's dtype,
    over column chunks of the (m, n) buffer ``b``; returns an (n,) buffer."""
    m, n = b.shape
    out = torch.empty(n, dtype=b.dtype, device=b.device)
    step = max(1, _CHUNK_ELEMS // max(m, 1))
    for c0 in range(0, n, step):
        c = slice(c0, min(n, c0 + step))
        out[c] = scale_fn(b[:, c].float()).to(b.dtype)
    return out


def _anchor_of(state) -> Optional[Packed]:
    """The recovery point, the unstacked model a rejoining worker resumes
    from: the in-flight collective (the freshest anchor; an avg-rebase
    in-flight's ``avg``; a gossip push collapsed into the mass-weighted
    consensus Σ_i mix_i / Σ_i w_i), else the strategy's anchor z. ``None``
    when the strategy carries no anchor (local_sgd, sync_sgd): the caller
    falls back to the live-worker mean."""
    infl = state.inflight
    if infl is not None:
        mix, w = getattr(infl, "mix", None), getattr(infl, "w", None)
        if mix is not None and w is not None:
            wsum = torch.sum(w.float())
            return Packed(tuple(_row_sum(b, lambda t: torch.sum(t, dim=0) / wsum) for b in mix.buffers), mix.layout)
        return getattr(infl, "avg", infl)
    return getattr(state.vars, "z", None)


def resync_from_anchor(state, resync_mask):
    """Overwrite the plane rows of the workers flagged in ``resync_mask``
    ((m,) bool, on the host) with the anchor, in place; other rows are left
    as they are. Only x is re-synced: the worker's optimizer state and the
    strategy's anchor-shaped state stay. Returns the state."""
    mask = np.asarray(resync_mask, bool)
    rows = [int(i) for i in np.nonzero(mask)[0]]
    anchor = _anchor_of(state)
    x = state.x
    if anchor is None:
        # no anchor: recover onto the mean of the workers that were not excluded
        w = (~mask).astype(np.float32)
        w = w / np.sum(w, dtype=np.float32)
        wt = torch.from_numpy(w).to(x.buffers[0].device)[:, None]
        anchor = Packed(tuple(_row_sum(b, lambda t: torch.sum(t * wt, dim=0)) for b in x.buffers), x.layout)
    for b, a in zip(x.buffers, anchor.buffers):
        for i in rows:
            b[i].copy_(a)
    return state


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
        mem = self.membership_at(r, device=state.x.buffers[0].device)
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
