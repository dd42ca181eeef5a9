"""Worker-stacked, plane-resident training state (counterpart of the packed
path of ``repro.training.train_state``).

``x`` is the worker-stacked :class:`~repro_torch.parallel.packing.Packed`
plane for its whole life: packed once here, updated in place by the local
steps and the round boundaries. ``opt`` holds the optimizer's flat state,
``vars`` the strategy's anchor-shaped planes, ``inflight`` the anchor
launched at the last boundary and consumed at the next, and ``membership``
the live workers of a degraded round (``None``: fully live), which the fault
harness installs and clears between rounds.

With ``AlgoConfig.offload`` the state is built offloaded, as the reference
builds it: ``opt``, ``vars`` and ``inflight`` are
:class:`~repro_torch.parallel.offload.HostPlane` trees from the start (x
stays on the device), chunked by the plan of ``offload_chunk_mb``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.strategy import AlgoVars, CommStrategy
from repro_torch.optim.optimizers import Optimizer, offload_capable
from repro_torch.parallel import offload as off
from repro_torch.parallel.packing import Packed, leaf_views, pack, tree_flatten, tree_unflatten


class TrainState(NamedTuple):
    x: Packed  # worker-stacked parameter plane (m, n) per bucket
    opt: Any  # PackedSGDState / PackedAdamState
    vars: AlgoVars
    step: torch.Tensor  # 0-dim int32: local steps taken
    inflight: Any = None  # anchor launched last boundary, consumed next
    membership: Any = None  # repro_torch.fault.Membership of a degraded round; None = fully live


def make_train_state(params: dict, m: int, optimizer: Optimizer, strategy: CommStrategy) -> TrainState:
    """All m workers start at ``params`` (Theorem 1's initialization)."""
    leaves, paths = tree_flatten(params)
    x = pack(tree_unflatten(paths, [t.expand(m, *t.shape) for t in leaves]), lead=1)
    vars = strategy.init_vars(x)
    opt, inflight = optimizer.init_packed(x), strategy.init_inflight(x, vars)
    if strategy.cfg.offload and offload_capable(optimizer):
        plan = off.OffloadPlan.for_layout(x.layout, float(strategy.cfg.offload_chunk_mb))
        opt, vars, inflight = (off.tree_offload(t, plan) for t in (opt, vars, inflight))
    return TrainState(
        x=x,
        opt=opt,
        vars=vars,
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        inflight=inflight,
    )


def consensus_params(state: TrainState) -> dict:
    """The averaged model used for evaluation (the paper's y_k): the f32
    worker mean of every leaf."""
    means = [torch.mean(v.float(), dim=0) for v in leaf_views(state.x)]
    return tree_unflatten(state.x.layout.paths, means)
