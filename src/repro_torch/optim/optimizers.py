"""Local optimizers over the packed plane (counterpart of the packed path of
``repro.optim.optimizers``).

The optimizer state lives as flat buffers between round boundaries — SGD
momentum as a plane of the parameter dtype, AdamW's mu/nu as f32 planes
element-aligned with the parameter plane, and one step count shared by all
workers (they step in lockstep) — and a step is one fused kernel launch per
dtype bucket (K1 ``sgd_step``, K2 ``adamw_step``). Both update the
parameter plane and the state **in place** and return them.

AdamW's bias corrections c1 = 1 − b1^t, c2 = 1 − b2^t are computed once per
step from the shared count, in f32 on the device, as the reference does.

``step_streamed`` is the same update with the state planes host-resident
(``AlgoConfig.offload``): :func:`repro_torch.parallel.offload.streamed_update`
walks them chunk by chunk through two device staging chunks a plane, and K1
or K2 runs in its window form on each chunk (the chunk's columns of x and g
against the staged state), so the result is bitwise ``step_packed``'s. The
Adam count stays on the device. The per-leaf ``init``/``step`` of the
reference are not here (ROADMAP Queue 1 item 4b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.config.base import OptimizerConfig
from repro_torch.kernels.opt_step import ops as opt_ops
from repro_torch.parallel import offload
from repro_torch.parallel.packing import Packed, packed_like, view_leaf

F32 = torch.float32


class PackedSGDState(NamedTuple):
    momentum: Packed  # worker-stacked plane of the parameter dtype


class PackedAdamState(NamedTuple):
    mu: Packed  # f32 plane, element-aligned with the parameter plane
    nu: Packed
    count: torch.Tensor  # 0-dim int32: one count for all workers and leaves


@dataclass(frozen=True)
class Optimizer:
    init_packed: Callable  # (px: Packed) -> state
    step_packed: Callable  # (state, px, pg, lr) -> (state, px), in place
    # the host-offloaded variant (None: resident only): the state's planes
    # are HostPlanes, streamed through offload.streamed_update;
    # (state, px, pg, lr) -> (state, px), in place
    step_streamed: Optional[Callable] = None


def offload_capable(opt: Optimizer) -> bool:
    """Whether ``opt`` has the host-offloaded streamed local step."""
    return opt.step_streamed is not None


def offload_state(state, plan: offload.OffloadPlan):
    """Host-offload a packed optimizer state: every ``Packed`` plane becomes
    a chunked :class:`~repro_torch.parallel.offload.HostPlane`; the Adam
    count stays on the device."""
    return offload.tree_offload(state, plan)


def sgd(momentum: float = 0.9, nesterov: bool = True, weight_decay: float = 0.0) -> Optimizer:
    def init_packed(px: Packed) -> PackedSGDState:
        return PackedSGDState(momentum=packed_like(px, 0.0))

    def step_packed(state: PackedSGDState, px: Packed, pg: Packed, lr):
        for bx, bg, bm in zip(px.buffers, pg.buffers, state.momentum.buffers):
            opt_ops.sgd_step(bx, bg, bm, lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
        return state, px

    def step_streamed(state: PackedSGDState, px: Packed, pg: Packed, lr):
        # K1 on each chunk's window: elementwise, so bitwise step_packed
        def apply_chunk(x_w, g_w, m_w):
            opt_ops.sgd_step_window(x_w, g_w, m_w, lr, momentum=momentum, nesterov=nesterov,
                                    weight_decay=weight_decay)

        offload.streamed_update(apply_chunk, (state.momentum,), px, pg)
        return state, px

    return Optimizer(init_packed=init_packed, step_packed=step_packed, step_streamed=step_streamed)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init_packed(px: Packed) -> PackedAdamState:
        return PackedAdamState(
            mu=packed_like(px, 0.0, dtype=F32),
            nu=packed_like(px, 0.0, dtype=F32),
            count=torch.zeros((), dtype=torch.int32, device=px.buffers[0].device),
        )

    def corrections(state):
        count = state.count + 1
        t = count.to(F32)
        return count, 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)

    def step_packed(state: PackedAdamState, px: Packed, pg: Packed, lr):
        count, c1, c2 = corrections(state)
        for bx, bg, bmu, bnu in zip(px.buffers, pg.buffers, state.mu.buffers, state.nu.buffers):
            opt_ops.adamw_step(bx, bg, bmu, bnu, lr, c1, c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        return state._replace(count=count), px

    def step_streamed(state: PackedAdamState, px: Packed, pg: Packed, lr):
        # the bias corrections once a step, outside the chunk walk: step_packed's values
        count, c1, c2 = corrections(state)

        def apply_chunk(x_w, g_w, mu_w, nu_w):
            opt_ops.adamw_step_window(x_w, g_w, mu_w, nu_w, lr, c1, c2, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay)

        offload.streamed_update(apply_chunk, (state.mu, state.nu), px, pg)
        return state._replace(count=count), px

    return Optimizer(init_packed=init_packed, step_packed=step_packed, step_streamed=step_streamed)


def packed_global_norm(pg: Packed, per_bucket: bool = False) -> torch.Tensor:
    """Per-worker global gradient norm of a worker-stacked plane: (m,) f32.
    By default each leaf's window is reduced and the leaves summed in
    flatten order, as the reference's per-leaf walk; ``per_bucket`` sums one
    partial per bucket (``AlgoConfig.packed_clip``). The sums inside a leaf
    run in PyTorch's order, so either is a few ulps from the reference."""
    if per_bucket:
        sq = sum(torch.sum(torch.square(b.float()), dim=-1) for b in pg.buffers)
    else:
        m = pg.lead_shape[0]
        sq = sum(torch.sum(torch.square(view_leaf(pg, s.index).float().reshape(m, -1)), dim=-1)
                 for s in pg.layout.slots)
    return torch.sqrt(sq)


def clip_packed_by_global_norm_(pg: Packed, max_norm: float, per_bucket: bool = False) -> torch.Tensor:
    """Scale each worker's gradient plane, in place, so its global norm is at
    most ``max_norm``. Returns the (m,) norms before clipping."""
    norm = packed_global_norm(pg, per_bucket=per_bucket)
    # a true division (a Python scalar over a tensor is a reciprocal product)
    scale = torch.clamp(torch.div(torch.full_like(norm, max_norm), norm + 1e-12), max=1.0)
    for b in pg.buffers:
        b.copy_((b * scale[:, None]).to(b.dtype))
    return norm


def from_config(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "sgd":
        return sgd(cfg.momentum, cfg.nesterov, cfg.weight_decay)
    if cfg.name == "adamw":
        return adamw(cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.name}")
