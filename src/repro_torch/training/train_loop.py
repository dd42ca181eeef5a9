"""Round engine (counterpart of ``repro.training.train_loop``).

One round is τ local steps, then the strategy's boundary:

    τ × [gradient plane → transform_grads_packed → optimizer step (K1/K2)
         → local_post_update_packed]
    boundary_round (K3/K4 for Overlap-Local-SGD, K5 for sparse gossip; on a
                    worker mesh their rank forms)

That is the plane-resident path (a packed strategy and an optimizer with a
packed step). The per-leaf path (``AlgoConfig.packed=False``, a legacy
``Algorithm``, an optimizer without a packed step) runs the same round over
a nested dict of worker-stacked leaves: per-leaf gradients (each leaf's
``.grad`` preset to a zeroed tensor of its own), per-worker
``clip_by_global_norm_``, ``transform_grads``, the optimizer's per-leaf
``step`` (the reference's ``jax.vmap`` over the workers, batched) and
``local_post_update``; then ``boundary_round``, which runs the strategy's
two phases per leaf (``tree_probe`` with ``probe=True``). A per-leaf state
handed to the packed engine migrates its x into the plane first.

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

On a worker mesh (:mod:`repro_torch.parallel.sharding`) the state holds
this rank's m/W rows; a round takes the full ``(τ, m, b, …)`` batch and
slices the rank's rows, runs the local steps on its rows unchanged, and
ends in the strategy's rank boundary (with ``probe`` and the state's (m,)
membership, as on one process), whose collective (an all-reduce, or the
gossip family's neighbour exchange) may still be in flight when the round
returns; PowerSGD's gradient hook all-reduces its factor sums at every
step. :func:`drain` waits on the collective and finishes it, so that the
state equals the one-device run's at the same step. Per-worker metrics
are the rank's own rows; the probe's stats are over all m workers, equal on
every rank. The per-leaf path runs there too: x is a dict of the rank's
``(r, ...)`` leaves and the per-leaf boundary reduces over the ranks
(:mod:`repro_torch.core.strategy`). So does offload: each rank streams the
optimizer state of its rows from its own pinned host stacks, and the rank
in-flight kinds keep their anchor-shaped planes on the host between
boundaries while their f32 wire buffer stays on the card.

With fsdp F > 1 (ROADMAP item 10c, first part: ZeRO-3 on the packed
plane) the rank holds its rows' column slice: a local step gathers the
worker's whole rows over the fsdp group, takes the gradient of the rank's
b/F examples (``sharding.batch_shard``: a b or a ``microbatch`` that F does
not divide raises), reduce-scatters it back in f32 over the fsdp group
divided by F (the mean of the shards' means is the worker's whole-batch
gradient: every loss of the port is a plain mean over equal shards) and
steps K1/K2 on the slice; clipping adds the slices' squares over the fsdp
group. A round's metrics are the means over the worker's F ranks (one
all-reduce a round), equal on its F ranks.

With ``AlgoConfig.offload`` (the reference's residency, DESIGN.md §9) the
optimizer state, vars and the in-flight plane are host-resident
:class:`~repro_torch.parallel.offload.HostPlane` trees between rounds; x
stays on the device. A round restores vars at its start (the copy overlaps
the first step's gradient; the compute stream waits for it just before the
first hook that reads vars), streams the optimizer state through
``step_streamed`` every local step, restores the in-flight plane at the
boundary (before the window when the strategy consumes it mid-round) and
sends vars and the in-flight plane back to their host stacks after the
boundary, in one walk, so that a plane held by both (a rank boundary's
anchor is vars.z and the in-flight value's base) takes one host copy. A
resident state is adopted into the offloaded form.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.strategy import as_strategy, check_fsdp_path, check_rank_path, finish_inflight, is_rank_inflight
from repro_torch.optim.optimizers import (
    Optimizer,
    clip_by_global_norm_,
    clip_packed_by_global_norm_,
    offload_capable,
    packed_capable,
)
from repro_torch.parallel import offload as off
from repro_torch.parallel import sharding
from repro_torch.parallel.packing import (
    Packed,
    leaf_views,
    pack,
    packed_like,
    tensors_of,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.training.train_state import TrainState
from repro_torch.utils.tree import tree_map


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


def _grad_leaves(x, g):
    """(paths, leaves of x, matching leaves of g): views of the planes, or
    per leaf fresh aliases of x's tensors (the state's own tensors never
    become autograd leaves)."""
    if isinstance(x, Packed):
        return x.layout.paths, leaf_views(x), leaf_views(g)
    leaves, paths = tree_flatten(x)
    return paths, [t.detach() for t in leaves], tree_flatten(g)[0]


def _zeros_like(x, dtype=None):
    if isinstance(x, Packed):
        return packed_like(x, 0.0, dtype=dtype)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=dtype or t.dtype, device=t.device), x)


def _grads_into(loss_fn: Callable, x, g, batch, split: Optional[Callable]) -> dict:
    """Accumulate each worker's gradient into ``g`` (a plane like ``x``, or
    a tree like it), in place; return the detached metrics, each (m,).
    ``split``: the ``per_worker`` mode."""
    paths, views, gviews = _grad_leaves(x, g)
    if split is None:
        views = _as_leaves(views, gviews)
        losses, metrics = loss_fn(tree_unflatten(paths, views), batch)
        _backward(torch.sum(losses), views)
        return {k: v.detach() for k, v in metrics.items()}
    per_worker_metrics = []
    for i in range(views[0].shape[0]):
        tree, leaves = [], []
        for path, v, gv in zip(paths, views, gviews):
            piece, gpiece = split(path, v[i]), split(path, gv[i])
            many = isinstance(piece, list)
            leaves += _as_leaves(piece if many else [piece], gpiece if many else [gpiece])
            tree.append(piece)
        loss, metrics = loss_fn(tree_unflatten(paths, tree), batch_map(lambda t: t[i], batch))
        _backward(loss, leaves)
        per_worker_metrics.append({k: v.detach() for k, v in metrics.items()})
    return {k: torch.stack([mt[k] for mt in per_worker_metrics]) for k in per_worker_metrics[0]}


def gradient_plane(loss_fn: Callable, px, batch, *, microbatch: Optional[int] = None,
                   per_worker: Optional[Callable] = None):
    """The worker-stacked gradients of one local step (with microbatch
    accumulation in f32, as the reference) and the step's metrics: a plane
    for a plane ``px``, a tree of (m, ...) leaves for a per-leaf ``px``."""
    b = _first(batch).shape[1]
    if microbatch is None or b <= microbatch:
        pg = _zeros_like(px)
        return pg, _grads_into(loss_fn, px, pg, batch, per_worker)
    k = b // microbatch
    acc = _zeros_like(px, dtype=torch.float32)
    msum = None
    for j in range(k):
        mb = batch_map(lambda t: t[:, j * microbatch : (j + 1) * microbatch], batch)
        pg = _zeros_like(px)
        mets = _grads_into(loss_fn, px, pg, mb, per_worker)
        for a, g in zip(tensors_of(acc), tensors_of(pg)):
            a.add_(g.float())
        mets = {name: v.float() for name, v in mets.items()}
        msum = mets if msum is None else {name: msum[name] + v for name, v in mets.items()}
    kt = torch.full((), float(k), dtype=torch.float32, device=tensors_of(px)[0].device)
    means = [(a / kt).to(xb.dtype) for a, xb in zip(tensors_of(acc), tensors_of(px))]
    pg = Packed(tuple(means), px.layout) if isinstance(px, Packed) else tree_unflatten(tree_flatten(px)[1], means)
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
    updated in place and returned. ``strategy``: a CommStrategy or a legacy
    ``Algorithm`` (wrapped); ``per_worker``: see the module docstring;
    ``probe``: add the consensus stats to the metrics."""
    strategy = as_strategy(strategy)
    packed_step = strategy.packed and packed_capable(optimizer)
    per_bucket_clip = bool(strategy.cfg.packed_clip)
    offload_on = bool(strategy.cfg.offload)
    # offload never falls back to a resident step: that would keep the state
    # on the card the flag was set to relieve
    if offload_on and not (packed_step and offload_capable(optimizer)):
        raise ValueError("AlgoConfig.offload requires a packed strategy and an optimizer with a streamed step "
                         "(step_streamed)")
    chunk_mb = float(strategy.cfg.offload_chunk_mb)

    def round_step(state: TrainState, round_batch) -> Tuple[TrainState, dict]:
        x, opt, vars, step, inflight, membership = state
        if packed_step and not isinstance(x, Packed):
            x = pack(x, lead=1)  # a per-leaf x migrates into the plane
        mesh = sharding.current_mesh()
        fsdp = mesh is not None and mesh.fsdp > 1
        if mesh is not None:  # this rank's rows of the round batch (with fsdp > 1, its share of their examples)
            check_rank_path(strategy)
            check_fsdp_path(strategy, packed_step)
            lo, hi = mesh.rows(tensors_of(x)[0].shape[0] * mesh.size)
            if _first(round_batch).shape[1] != mesh.size * (hi - lo):
                raise ValueError(f"on a worker mesh a round batch holds all {mesh.size * (hi - lo)} workers, "
                                 f"got {_first(round_batch).shape[1]}")
            round_batch = sharding.batch_shard(batch_map(lambda t: t[:, lo:hi], round_batch), mesh, microbatch)
        if offload_on:
            plan = off.plan_of(opt)
            if plan is None:  # adoption: a resident state entering the offloaded engine
                plan = off.OffloadPlan.for_layout(x.layout, chunk_mb)
                opt = off.tree_offload(opt, plan)
            host_vars, host_inflight = vars, inflight
            vars, pending = off.tree_restore_async(vars)  # the H2D rides the first step's gradient
            if strategy.consumes_inflight_midround:
                inflight, infl_pending = off.tree_restore_async(inflight)
                pending.add(infl_pending)
        per_step, lrs = [], []
        for k in range(_first(round_batch).shape[0]):
            lr = schedule(step)
            lrs.append(lr)
            if fsdp:  # ZeRO-3: the worker's whole rows gathered, the gradient reduce-scattered back
                full = sharding.gather_columns(x, mesh)
                pg, metrics = gradient_plane(loss_fn, full, batch_map(lambda t: t[k], round_batch),
                                             microbatch=None if microbatch is None else microbatch // mesh.fsdp,
                                             per_worker=per_worker)
                del full
                pg = sharding.reduce_scatter_columns(pg, x, mesh)
            else:
                pg, metrics = gradient_plane(loss_fn, x, batch_map(lambda t: t[k], round_batch),
                                             microbatch=microbatch, per_worker=per_worker)
            if packed_step:
                if grad_clip > 0.0:
                    clip_packed_by_global_norm_(pg, grad_clip, per_bucket=per_bucket_clip)
                if offload_on:
                    pending.wait()  # vars (and a mid-round inflight) on the device from here on
                pg, vars = strategy.transform_grads_packed(pg, vars)
                if offload_on:
                    opt, x = optimizer.step_streamed(opt, x, pg, lr)
                else:
                    opt, x = optimizer.step_packed(opt, x, pg, lr)
                x = strategy.local_post_update_packed(x, vars, inflight, k)
            else:  # per leaf: the reference's vmapped clip, hook and step, batched over the workers
                if grad_clip > 0.0:
                    clip_by_global_norm_(pg, grad_clip)
                pg, vars = strategy.transform_grads(pg, vars)
                opt, x = optimizer.step(opt, x, pg, lr)
                x = strategy.local_post_update(x, vars, inflight, k)
            del pg  # free this step's gradients before the next ones are made
            step = step + 1
            per_step.append(metrics)
        if fsdp:  # the worker's metrics: the mean of its F ranks' shard means, one sum a round
            names = list(per_step[0])
            sums = sharding.all_reduce_fsdp_(torch.stack([torch.stack([mt[n].float() for n in names])
                                                          for mt in per_step]), mesh)
            ft = torch.full((), float(mesh.fsdp), dtype=torch.float32, device=sums.device)
            per_step = [{n: (sums[k, i] / ft).to(per_step[k][n].dtype) for i, n in enumerate(names)}
                        for k in range(len(per_step))]
        per_step = [dict(mt, lr=lr.expand_as(mt["loss"])) for mt, lr in zip(per_step, lrs)]
        if offload_on:
            pending.wait()
            inflight = off.tree_restore(inflight)  # a no-op when already on the device
        out = strategy.boundary_round(x, vars, inflight, probe=probe, membership=membership)
        x, vars, inflight = out[:3]
        if offload_on:
            # D2H: the boundary's outputs back into their host stacks until the next round
            vars, inflight = off.tree_offload((vars, inflight), plan, into=(host_vars, host_inflight))
        metrics = {name: torch.stack([m[name] for m in per_step]) for name in per_step[0]}
        if probe:
            metrics.update(consensus_drift=out[3].drift, consensus_scale=out[3].scale)
        return TrainState(x=x, opt=opt, vars=vars, step=step, inflight=inflight, membership=membership), metrics

    return round_step


def drain(state: TrainState) -> TrainState:
    """Wait on the collective a rank boundary left in flight and finish it
    (Overlap-Local-SGD's anchor, sparse_anchor's sparse step with its error
    feedback, the avg-rebase strategies' average, the gossip mix of the
    rank's rows; per leaf the same, leaf by leaf):
    ``state.inflight`` and ``state.vars`` then equal the one-device run's at
    the same step. Idempotent, and a no-op off a worker mesh; the next
    boundary starts from the finished value, as the first one does. Call it
    at the end of a run and before anything reads the anchor. An offloaded
    state (its optimizer state on the host) is finished on device copies of
    vars and the in-flight planes, and vars and the finished value go back
    to the host: vars into their own stacks."""
    if not is_rank_inflight(state.inflight):
        return state
    plan = off.plan_of(state.opt)
    if plan is None:
        return state._replace(inflight=finish_inflight(state.inflight, state.vars))
    vars = off.tree_restore(state.vars)
    done = finish_inflight(off.tree_restore(state.inflight), vars)
    vars, done = off.tree_offload((vars, done), plan, into=(state.vars, None))
    return state._replace(vars=vars, inflight=done)
