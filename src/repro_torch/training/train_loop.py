"""Round engine over the plane-resident state (counterpart of the packed path
of ``repro.training.train_loop``).

One round is τ local steps, then the strategy's boundary:

    τ × [gradient plane → transform_grads_packed → optimizer step (K1/K2)
         → local_post_update_packed]
    boundary_round (K3/K4 for Overlap-Local-SGD, K5 for sparse gossip)

The gradient is taken with the plane itself as the variable. Each leaf is
a view of the parameter plane, made an autograd leaf whose ``.grad`` is
preset to the matching view of one zeroed gradient plane per bucket, so
backward accumulates every leaf's gradient straight into that plane (its
padding stays zero). There is no per-leaf gradient tensor to pack, and the
cost does not grow with the number of leaves beyond one view each.

Two forms of ``loss_fn``, both giving each worker the gradient of its own
loss, as the reference's vmapped grad does:

* stacked (the default): ``loss_fn(params, batch) -> (losses, metrics)``
  takes worker-stacked parameters (leaves ``(m, ...)``) and batch (leaves
  ``(m, b, ...)``) and returns the (m,) per-worker losses, whose sum is
  differentiated once (the classifier's batched MLP);
* ``per_worker=split``: ``loss_fn(params, batch) -> (loss, metrics)`` is one
  worker's scalar loss. It is called for worker i = 0 .. m−1 on worker i's
  leaves (views of row i of the plane, each its own autograd leaf with its
  ``.grad`` preset to row i of the gradient plane) and worker i's batch,
  and differentiated at once, so only one worker's activations are alive
  at a time (the LM). ``split(path, leaf)`` returns the leaf or cuts it
  into a list of views that become separate autograd leaves (the
  transformer's stacked layers,
  :func:`repro_torch.models.transformer.split_layers`).

A batch is a tuple of tensors or a dict of them. Metrics stay on the
device: a round returns them as ``(τ, m)`` tensors. The boundary runs under
``state.membership`` (installed by the fault harness, carried through
unchanged); with ``probe=True`` the round's metrics also hold the
pre-boundary plane's ``consensus_drift`` and ``consensus_scale`` (0-dim),
the adaptive-τ controller's inputs.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer, clip_packed_by_global_norm_
from repro_torch.parallel.packing import Packed, leaf_views, packed_like, tree_unflatten
from repro_torch.training.train_state import TrainState


def batch_map(fn: Callable, batch):
    """``fn`` applied to every tensor of a tuple or dict batch."""
    if isinstance(batch, dict):
        return {k: fn(t) for k, t in batch.items()}
    return tuple(fn(t) for t in batch)


def _first(batch) -> torch.Tensor:
    return next(iter(batch.values())) if isinstance(batch, dict) else batch[0]


def _backward(loss: torch.Tensor, leaves) -> None:
    with warnings.catch_warnings():
        # the preset grads are strided windows of the plane by design
        warnings.filterwarnings("ignore", message="grad and param do not obey the gradient layout contract")
        loss.backward(inputs=leaves)


def _as_leaves(views, grads) -> list:
    """Make each view an autograd leaf whose ``.grad`` is its gradient
    window; return the leaves."""
    for v, g in zip(views, grads):
        v.requires_grad_(True)
        v.grad = g
    return list(views)


def _grads_into(loss_fn: Callable, px: Packed, pg: Packed, batch, split: Optional[Callable]) -> dict:
    """Accumulate each worker's gradient into ``pg`` (in place); return the
    detached metrics, each (m,). ``split``: the ``per_worker`` mode."""
    paths = px.layout.paths
    if split is None:
        views = _as_leaves(leaf_views(px), leaf_views(pg))
        losses, metrics = loss_fn(tree_unflatten(paths, views), batch)
        _backward(torch.sum(losses), views)
        return {k: v.detach() for k, v in metrics.items()}
    views, gviews = leaf_views(px), leaf_views(pg)
    per_worker_metrics = []
    for i in range(px.lead_shape[0]):
        tree, leaves = [], []
        for path, v, g in zip(paths, views, gviews):
            piece, gpiece = split(path, v[i]), split(path, g[i])
            many = isinstance(piece, list)
            leaves += _as_leaves(piece if many else [piece], gpiece if many else [gpiece])
            tree.append(piece)
        loss, metrics = loss_fn(tree_unflatten(paths, tree), batch_map(lambda t: t[i], batch))
        _backward(loss, leaves)
        per_worker_metrics.append({k: v.detach() for k, v in metrics.items()})
    return {k: torch.stack([mt[k] for mt in per_worker_metrics]) for k in per_worker_metrics[0]}


def gradient_plane(loss_fn: Callable, px: Packed, batch, *, microbatch: Optional[int] = None,
                   per_worker: Optional[Callable] = None) -> Tuple[Packed, dict]:
    """The worker-stacked gradient plane of one local step (with microbatch
    accumulation in f32, as the reference) and the step's metrics."""
    b = _first(batch).shape[1]
    if microbatch is None or b <= microbatch:
        pg = packed_like(px, 0.0)
        return pg, _grads_into(loss_fn, px, pg, batch, per_worker)
    k = b // microbatch
    acc = packed_like(px, 0.0, dtype=torch.float32)
    msum = None
    for j in range(k):
        mb = batch_map(lambda t: t[:, j * microbatch : (j + 1) * microbatch], batch)
        pg = packed_like(px, 0.0)
        mets = _grads_into(loss_fn, px, pg, mb, per_worker)
        for a, g in zip(acc.buffers, pg.buffers):
            a.add_(g.float())
        mets = {name: v.float() for name, v in mets.items()}
        msum = mets if msum is None else {name: msum[name] + v for name, v in mets.items()}
    kt = torch.full((), float(k), dtype=torch.float32, device=px.buffers[0].device)
    pg = Packed(tuple((a / kt).to(xb.dtype) for a, xb in zip(acc.buffers, px.buffers)), px.layout)
    return pg, {name: v / kt for name, v in msum.items()}


def make_round_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    strategy,
    schedule: Callable,
    grad_clip: float = 0.0,
    microbatch: Optional[int] = None,
    per_worker: Optional[Callable] = None,
    probe: bool = False,
):
    """``round_step(state, round_batch) -> (state, metrics)``; ``round_batch``
    is a tuple or dict of device tensors ``(τ, m, b, ...)``. The state is
    updated in place and returned. ``per_worker``: see the module
    docstring; ``probe``: add the consensus stats to the metrics."""
    per_bucket_clip = bool(strategy.cfg.packed_clip)

    def round_step(state: TrainState, round_batch) -> Tuple[TrainState, dict]:
        x, opt, vars, step, inflight, membership = state
        per_step = []
        for k in range(_first(round_batch).shape[0]):
            lr = schedule(step)
            pg, metrics = gradient_plane(loss_fn, x, batch_map(lambda t: t[k], round_batch), microbatch=microbatch,
                                         per_worker=per_worker)
            if grad_clip > 0.0:
                clip_packed_by_global_norm_(pg, grad_clip, per_bucket=per_bucket_clip)
            pg, vars = strategy.transform_grads_packed(pg, vars)
            opt, x = optimizer.step_packed(opt, x, pg, lr)
            del pg  # free this step's gradient plane before the next one is made
            x = strategy.local_post_update_packed(x, vars, inflight, k)
            step = step + 1
            per_step.append(dict(metrics, lr=lr.expand_as(metrics["loss"])))
        out = strategy.boundary_round(x, vars, inflight, probe=probe, membership=membership)
        x, vars, inflight = out[:3]
        metrics = {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}
        if probe:
            metrics.update(consensus_drift=out[3].drift, consensus_scale=out[3].scale)
        return TrainState(x=x, opt=opt, vars=vars, step=step, inflight=inflight, membership=membership), metrics

    return round_step
