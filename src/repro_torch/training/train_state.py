"""Worker-stacked training state (counterpart of
``repro.training.train_state``).

With a packed strategy and an optimizer with a packed step (the default)
the state is plane-resident: ``x`` is the worker-stacked
:class:`~repro_torch.parallel.packing.Packed` plane for its whole life,
packed once here and updated in place by the local steps and the round
boundaries, and ``opt`` holds the optimizer's flat state. Otherwise
(``AlgoConfig.packed=False``, a legacy ``Algorithm``, or an optimizer with
no packed step) ``x`` is a nested dict of worker-stacked leaves ``(m, ...)``,
each with its own storage, and ``opt`` the per-leaf optimizer state. ``vars``
holds the strategy's anchor-shaped state and ``inflight`` the anchor
launched at the last boundary and consumed at the next, both from the
strategy's ``init_vars``/``init_inflight`` (a packed strategy packs a
per-leaf x for its own slots, as the reference does); ``membership`` the
live workers of a degraded round (``None``: fully live), which the fault
harness installs and clears between rounds.

On a worker mesh (:func:`repro_torch.parallel.sharding.mesh_context`) the
state is this rank's: x holds its m/W rows (m must divide by W) and, with
fsdp F > 1, their column slice (a :class:`~repro_torch.parallel.sharding.Sharded`
of ``flat_param``), and the optimizer state matches them. The anchor-shaped
state of the packed resident path (z, v, the first in-flight anchor, the
avg-rebase average) is the rank's piece of worker 0's row (``anchor_flat``:
1/(W·F) of each bucket); the avg-rebase strategies' first average is the
mean of m copies of a row, its x₀ the rank's own rows. Per leaf (F = 1), x
is a dict of the rank's ``(r, ...)`` leaves and the per-leaf optimizer state
matches them; offloaded (F = 1), the optimizer state of the rank's rows is
chunked by the plan of the rank's layout (lead r); both keep a replicated
anchor, as do sparse_anchor and PowerSGD. With F > 1 those paths, and MoE
segments, raise (:func:`~repro_torch.core.strategy.check_fsdp_path`).

With ``AlgoConfig.offload`` the state is built offloaded, as the reference
builds it: ``opt``, ``vars`` and ``inflight`` are
:class:`~repro_torch.parallel.offload.HostPlane` trees from the start (x
stays on the device), chunked by the plan of ``offload_chunk_mb``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.strategy import AlgoVars, as_strategy, check_fsdp_path, check_rank_path
from repro_torch.optim.optimizers import Optimizer, offload_capable, packed_capable
from repro_torch.parallel import offload as off
from repro_torch.parallel import sharding
from repro_torch.parallel.packing import Packed, leaf_views, pack, tree_flatten, tree_unflatten


class TrainState(NamedTuple):
    x: Any  # worker-stacked parameter plane (m, n) per bucket, or per-leaf (m, ...) leaves
    opt: Any  # PackedSGDState / PackedAdamState, or SGDState / AdamState per leaf
    vars: AlgoVars
    step: torch.Tensor  # 0-dim int32: local steps taken
    inflight: Any = None  # anchor launched last boundary, consumed next
    membership: Any = None  # repro_torch.fault.Membership of a degraded round; None = fully live

    ROWS = ("x",)  # a per-leaf x's leaves are worker-stacked (on a worker mesh the rank's rows)


def make_train_state(params: dict, m: int, optimizer: Optimizer, strategy) -> TrainState:
    """All m workers start at ``params`` (Theorem 1's initialization).
    ``strategy``: a CommStrategy or a legacy ``Algorithm`` (wrapped). On a
    worker mesh, this rank's m/W of them."""
    strategy = as_strategy(strategy)
    mesh = sharding.current_mesh()
    if mesh is not None:
        check_rank_path(strategy)
        lo, hi = mesh.rows(m)
        m = hi - lo
    leaves, paths = tree_flatten(params)
    packed_step = strategy.packed and packed_capable(optimizer)
    check_fsdp_path(strategy, packed_step, paths)
    stacked = [t.expand(m, *t.shape) for t in leaves]
    if packed_step:
        x = pack(tree_unflatten(paths, stacked), lead=1)
        if mesh is not None:  # with fsdp > 1: the rows' column slice
            x = sharding.shard_columns(x, mesh)
        opt = optimizer.init_packed(x)
    else:  # per leaf: each worker-stacked leaf a tensor of its own
        x = tree_unflatten(paths, [t.contiguous() for t in stacked])
        opt = optimizer.init(x)
    vars = strategy.init_vars(x)
    inflight = strategy.init_inflight(x, vars)
    if strategy.cfg.offload and isinstance(x, Packed) and offload_capable(optimizer):
        plan = off.OffloadPlan.for_layout(x.layout, float(strategy.cfg.offload_chunk_mb))
        opt, vars, inflight = (off.tree_offload(t, plan) for t in (opt, vars, inflight))
    return TrainState(
        x=x,
        opt=opt,
        vars=vars,
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        inflight=inflight,
    )


def params_view(state: TrainState) -> dict:
    """The worker-stacked params as a nested dict (views of the plane when
    ``x`` is packed), whatever representation ``x`` is in."""
    x = state.x
    return tree_unflatten(x.layout.paths, leaf_views(x)) if isinstance(x, Packed) else x


def consensus_params(state: TrainState) -> dict:
    """The averaged model used for evaluation (the paper's y_k): the f32
    worker mean of every leaf, packed or per leaf."""
    leaves, paths = tree_flatten(params_view(state))
    return tree_unflatten(paths, [torch.mean(v.float(), dim=0) for v in leaves])
