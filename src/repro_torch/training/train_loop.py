"""Round engine over the plane-resident state (counterpart of the packed path
of ``repro.training.train_loop``).

One round is τ local steps, then the strategy's boundary:

    τ × [gradient plane → transform_grads_packed → optimizer step (K1/K2)]
    boundary_round (K3/K4 for Overlap-Local-SGD)

The gradient is taken with the plane itself as the variable. Each leaf is
a view of the parameter plane, made an autograd leaf whose ``.grad`` is
preset to the matching view of one zeroed gradient plane per bucket, so
backward accumulates every leaf's gradient straight into that plane (its
padding stays zero). There is no per-leaf gradient tensor to pack, and the
cost does not grow with the number of leaves beyond one view each.

``loss_fn(params, batch) -> (losses, metrics)`` takes worker-stacked
parameters (leaves ``(m, ...)``) and batch (leaves ``(m, b, ...)``) and
returns the (m,) per-worker losses; their sum is differentiated, so each
worker's gradient is its own loss's, as the reference's vmapped grad.

Metrics stay on the device: a round returns them as ``(τ, m)`` tensors.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer, clip_packed_by_global_norm_
from repro_torch.parallel.packing import Packed, leaf_views, packed_like, tree_unflatten
from repro_torch.training.train_state import TrainState


def _grads_into(loss_fn: Callable, px: Packed, pg: Packed, batch) -> dict:
    """Accumulate the gradient of the summed per-worker losses into ``pg``
    (in place); return the detached metrics."""
    views = leaf_views(px)
    for v, g in zip(views, leaf_views(pg)):
        v.requires_grad_(True)
        v.grad = g
    losses, metrics = loss_fn(tree_unflatten(px.layout.paths, views), batch)
    with warnings.catch_warnings():
        # the preset grads are strided windows of the plane by design
        warnings.filterwarnings("ignore", message="grad and param do not obey the gradient layout contract")
        torch.sum(losses).backward(inputs=views)
    return {k: v.detach() for k, v in metrics.items()}


def make_round_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    strategy,
    schedule: Callable,
    grad_clip: float = 0.0,
    microbatch: Optional[int] = None,
):
    """``round_step(state, round_batch) -> (state, metrics)``; ``round_batch``
    is a tuple of device tensors ``(τ, m, b, ...)``. The state is updated in
    place and returned."""
    per_bucket_clip = bool(strategy.cfg.packed_clip)

    def stacked_grads(px: Packed, batch) -> Tuple[Packed, dict]:
        b = batch[0].shape[1]
        if microbatch is None or b <= microbatch:
            pg = packed_like(px, 0.0)
            return pg, _grads_into(loss_fn, px, pg, batch)
        # gradient accumulation over microbatches, in f32 as the reference
        k = b // microbatch
        acc = packed_like(px, 0.0, dtype=torch.float32)
        msum = None
        for j in range(k):
            mb = tuple(t[:, j * microbatch : (j + 1) * microbatch] for t in batch)
            pg = packed_like(px, 0.0)
            mets = _grads_into(loss_fn, px, pg, mb)
            for a, g in zip(acc.buffers, pg.buffers):
                a.add_(g.float())
            mets = {name: v.float() for name, v in mets.items()}
            msum = mets if msum is None else {name: msum[name] + v for name, v in mets.items()}
        kt = torch.full((), float(k), dtype=torch.float32, device=px.buffers[0].device)
        pg = Packed(tuple((a / kt).to(xb.dtype) for a, xb in zip(acc.buffers, px.buffers)), px.layout)
        return pg, {name: v / kt for name, v in msum.items()}

    def round_step(state: TrainState, round_batch) -> Tuple[TrainState, dict]:
        x, opt, vars, step, inflight = state
        per_step = []
        for k in range(round_batch[0].shape[0]):
            lr = schedule(step)
            pg, metrics = stacked_grads(x, tuple(t[k] for t in round_batch))
            if grad_clip > 0.0:
                clip_packed_by_global_norm_(pg, grad_clip, per_bucket=per_bucket_clip)
            pg, vars = strategy.transform_grads_packed(pg, vars)
            opt, x = optimizer.step_packed(opt, x, pg, lr)
            step = step + 1
            per_step.append(dict(metrics, lr=lr.expand_as(metrics["loss"])))
        x, vars, inflight = strategy.boundary_round(x, vars, inflight)
        metrics = {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}
        return TrainState(x=x, opt=opt, vars=vars, step=step, inflight=inflight), metrics

    return round_step
