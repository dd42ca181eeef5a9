"""Local optimizers (counterpart of ``repro.optim.optimizers``): the packed
plane's fused steps and the per-leaf oracle.

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
Adam count stays on the device.

The per-leaf ``init``/``step`` (``AlgoConfig.packed=False``, or an
optimizer without a packed step) keep the state as nested dicts of
worker-stacked leaves ``(m, ...)``, each with its own storage, and a
per-worker Adam count ``(m,)``: the reference's ``jax.vmap`` of its per-leaf
step over the workers, written as one batched update a leaf. The update is
plain PyTorch (the reference's per-leaf step is jnp and reaches no Pallas
kernel), the chain of K1/K2's plain versions (``kernels/opt_step/ref.py``):
every op rounds on its own at the reference's rounding points, so on one
device the per-leaf step equals the packed step bit for bit. It too
updates x and the state in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.config.base import OptimizerConfig
from repro_torch.kernels.opt_step import ops as opt_ops
from repro_torch.kernels.opt_step import ref as opt_ref
from repro_torch.parallel import offload, sharding
from repro_torch.parallel.packing import Packed, column_chunks, packed_like, tensors_of, view_leaf
from repro_torch.utils.tree import tree_map

F32 = torch.float32


class SGDState(NamedTuple):
    momentum: dict  # like the worker-stacked params

    ROWS = ("momentum",)  # worker-stacked (on a worker mesh the rank's rows): the checkpointer's gather




class AdamState(NamedTuple):
    mu: dict  # f32, like the worker-stacked params
    nu: dict
    count: torch.Tensor  # (m,) int32: each worker's count (the reference's vmapped count)

    ROWS = ("mu", "nu", "count")


class PackedSGDState(NamedTuple):
    momentum: Packed  # worker-stacked plane of the parameter dtype


class PackedAdamState(NamedTuple):
    mu: Packed  # f32 plane, element-aligned with the parameter plane
    nu: Packed
    count: torch.Tensor  # 0-dim int32: one count for all workers and leaves


@dataclass(frozen=True)
class Optimizer:
    init: Callable  # (x_stacked: nested dict of (m, ...) leaves) -> per-leaf state
    step: Callable  # (state, x_stacked, grads, lr) -> (state, x_stacked), in place
    # the packed-plane variants (None: per-leaf only)
    init_packed: Optional[Callable] = None  # (px: Packed) -> state
    step_packed: Optional[Callable] = None  # (state, px, pg, lr) -> (state, px), in place
    # the host-offloaded variant (None: resident only): the state's planes
    # are HostPlanes, streamed through offload.streamed_update;
    # (state, px, pg, lr) -> (state, px), in place
    step_streamed: Optional[Callable] = None


def packed_capable(opt: Optimizer) -> bool:
    """Whether ``opt`` has the packed local step."""
    return opt.init_packed is not None and opt.step_packed is not None


def offload_capable(opt: Optimizer) -> bool:
    """Whether ``opt`` has the host-offloaded streamed local step."""
    return packed_capable(opt) and opt.step_streamed is not None


def _per_row(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """An (m,) per-worker value shaped to broadcast over t's (m, ...) rows."""
    return v.reshape((-1,) + (1,) * (t.dim() - 1))


def _leaf_update_(update, leaves, n_out: int):
    """``update`` (a plain chain of K1's or K2's) on column windows of one
    leaf's worker-stacked tensors viewed (m, n), its ``n_out`` new values
    written back into the first (x) and the last ``n_out - 1`` (the state),
    in place. Elementwise, so the windows give the whole leaf's values; they
    keep its f32 temporaries bounded (a full-width embedding leaf holds
    2e9 elements)."""
    rows = [t.reshape(t.shape[0], -1) for t in leaves]
    outs = [rows[0]] + rows[len(rows) - (n_out - 1):]
    for c in column_chunks(rows[0]):
        for dst, val in zip(outs, update(*(r[:, c] for r in rows))):
            dst[:, c] = val


def offload_state(state, plan: offload.OffloadPlan):
    """Host-offload a packed optimizer state: every ``Packed`` plane becomes
    a chunked :class:`~repro_torch.parallel.offload.HostPlane`; the Adam
    count stays on the device."""
    return offload.tree_offload(state, plan)


def sgd(momentum: float = 0.9, nesterov: bool = True, weight_decay: float = 0.0) -> Optimizer:
    def init(x) -> SGDState:
        return SGDState(momentum=tree_map(torch.zeros_like, x))

    def step(state: SGDState, x, grads, lr):
        def update(t, g, m):
            return opt_ref.sgd_update(t, g, m, lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)

        for leaf in zip(tensors_of(x), tensors_of(grads), tensors_of(state.momentum)):
            _leaf_update_(update, leaf, 2)
        return state, x

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

    return Optimizer(init=init, step=step, init_packed=init_packed, step_packed=step_packed,
                     step_streamed=step_streamed)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(x) -> AdamState:
        leaves = tensors_of(x)
        f32 = lambda t: torch.zeros(t.shape, dtype=F32, device=t.device)  # noqa: E731
        return AdamState(mu=tree_map(f32, x), nu=tree_map(f32, x),
                         count=torch.zeros((leaves[0].shape[0],), dtype=torch.int32, device=leaves[0].device))

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

    def step(state: AdamState, x, grads, lr):
        # each worker's corrections from its own count, as the vmapped reference
        count, c1, c2 = corrections(state)
        c1, c2 = c1[:, None], c2[:, None]  # one a row of the (m, n) windows

        def update(t, g, mu, nu):
            return opt_ref.adamw_update(t, g, mu, nu, lr, c1, c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

        for leaf in zip(tensors_of(x), tensors_of(grads), tensors_of(state.mu), tensors_of(state.nu)):
            _leaf_update_(update, leaf, 3)
        return state._replace(count=count), x

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

    return Optimizer(init=init, step=step, init_packed=init_packed, step_packed=step_packed,
                     step_streamed=step_streamed)


def global_norm(grads) -> torch.Tensor:
    """Per-worker global norm of worker-stacked gradients (nested dict of
    (m, ...) leaves): (m,) f32, each leaf reduced and the leaves summed in
    flatten order (the reference's ``global_norm`` vmapped over the workers;
    :func:`packed_global_norm`'s walk, bit for bit)."""
    leaves = tensors_of(grads)
    m = leaves[0].shape[0]
    return torch.sqrt(sum(torch.sum(torch.square(g.float().reshape(m, -1)), dim=-1) for g in leaves))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale each worker's gradients, in place, so their global norm is at
    most ``max_norm``. Returns the (m,) norms before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.div(torch.full_like(norm, max_norm), norm + 1e-12), max=1.0)
    for g in tensors_of(grads):
        g.copy_((g * _per_row(scale, g)).to(g.dtype))
    return norm


def packed_global_norm(pg: Packed, per_bucket: bool = False) -> torch.Tensor:
    """Per-worker global gradient norm of a worker-stacked plane: (m,) f32.
    By default each leaf's window is reduced and the leaves summed in
    flatten order, as the reference's per-leaf walk; ``per_bucket`` sums one
    partial per bucket (``AlgoConfig.packed_clip``). The sums inside a leaf
    run in PyTorch's order, so either is a few ulps from the reference. A
    rank's column slice (fsdp > 1) sums its buckets' squares and adds them
    over the worker's F ranks (one blocking all-reduce)."""
    if isinstance(pg, sharding.Sharded):  # a column slice: its rows' sums of squares, over the worker's F ranks
        sq = sum(torch.sum(torch.square(b.float()), dim=-1) for b in pg.buffers)
        return torch.sqrt(sharding.all_reduce_fsdp_(sq))
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
