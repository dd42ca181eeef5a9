"""Transfer from the JAX reference's data structures, after the caller has
turned every array into numpy (``jax.tree.map(np.asarray, ...)``). This
module imports no JAX; it reads the reference's objects by their fields.

* :func:`params_from_numpy` — a parameter tree (nested dicts; stacked
  ``seg{i}`` leaves keep their leading layer axis) → the port's tree, leaf
  for leaf.
* :func:`packed_from_numpy` — a packed plane → the port's ``Packed``, bit
  for bit (the two packages lay a tree out identically).
* :func:`state_from_numpy` — a plane-resident ``TrainState`` (x, opt, vars,
  step, inflight) → the port's ``TrainState``, bit for bit, f32 or bf16,
  with every strategy's slots: the gossip push weights and phase ``(w, t)``
  and ``GossipInflight(mix, w)``, the rebase strategies' ``Inflight(avg,
  x0)``, sparse_anchor's f32 error plane and PowerSGD's ``PowerState(q,
  err)``. The parity tests start both packages from the reference's
  ``Experiment.build()`` state this way (the classifier's and the LM's),
  because ``jax.random`` and ``torch.Generator`` draw different weights.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays → nested dicts of tensors on ``device``,
    cast to ``dtype`` when given (else the arrays' own dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = _tensor(tree)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def packed_from_numpy(p, layout, device="cpu"):
    """A reference ``Packed`` whose buffers are numpy arrays → the port's
    ``Packed`` on ``device``, bit for bit. ``layout`` is the port's layout of
    the same tree (retagged here for an f32 shadow plane such as AdamW's
    moments); raises unless the reference places every leaf the same way."""
    from repro_torch.parallel.packing import Packed

    ref = p.layout
    if tuple(ref.bucket_dtypes) != layout.bucket_dtypes:
        layout = layout.with_dtype(getattr(torch, ref.bucket_dtypes[0]))

    def key(s):
        return (s.index, s.bucket, tuple(s.shape), s.dtype, s.offset, s.size, s.stride)

    if [key(s) for s in ref.slots] != [key(s) for s in layout.slots] or tuple(ref.bucket_sizes) != layout.bucket_sizes:
        raise ValueError("the reference plane's layout differs from the port's")
    return Packed(tuple(_tensor(b).to(device) for b in p.buffers), layout)


def state_from_numpy(state, layout, device="cpu"):
    """A reference plane-resident ``TrainState`` whose arrays are numpy
    (x, opt, vars, step, inflight) → the port's ``TrainState`` on ``device``,
    bit for bit. ``layout`` is the port's layout of the parameter tree. The
    reference's slot types are recognised by their fields, not imported."""
    from repro_torch.core.powersgd import PowerState
    from repro_torch.core.strategy import AlgoVars, GossipInflight, _AvgRebaseStrategy
    from repro_torch.fault.membership import Membership
    from repro_torch.optim.optimizers import PackedAdamState, PackedSGDState
    from repro_torch.parallel.packing import tree_flatten
    from repro_torch.training.train_state import TrainState

    def tensor(a):
        return _tensor(a).to(device)

    def slot(v):
        """Any strategy slot: a plane, a named slot tuple, a tuple of arrays."""
        if v is None:
            return None
        if hasattr(v, "buffers") and hasattr(v, "layout"):
            return packed_from_numpy(v, layout, device)
        fields = getattr(v, "_fields", None)
        if fields == ("mix", "w"):
            return GossipInflight(mix=slot(v.mix), w=tensor(v.w))
        if fields == ("avg", "x0"):
            return _AvgRebaseStrategy.Inflight(avg=slot(v.avg), x0=slot(v.x0))
        if fields == ("q", "err"):
            qs, _ = tree_flatten(v.q)  # the reference's per-leaf tree, in the layout's leaf order
            return PowerState(q=tuple(None if q is None else tensor(q) for q in qs), err=slot(v.err))
        if isinstance(v, tuple) and fields is None:
            return tuple(tensor(a) for a in v)
        raise ValueError(f"unsupported strategy slot {type(v).__name__}")

    opt = state.opt
    if hasattr(opt, "momentum"):
        opt = PackedSGDState(momentum=slot(opt.momentum))
    elif hasattr(opt, "mu"):
        opt = PackedAdamState(mu=slot(opt.mu), nu=slot(opt.nu), count=tensor(opt.count))
    else:
        raise ValueError(f"unsupported optimizer state {type(opt).__name__}")
    v = state.vars
    vars = AlgoVars() if v is None else AlgoVars(z=slot(v.z), v=slot(v.v), extra=slot(v.extra))
    mem = getattr(state, "membership", None)
    mem = None if mem is None else Membership(mask=tensor(mem.mask), weights=tensor(mem.weights))
    return TrainState(x=slot(state.x), opt=opt, vars=vars, step=tensor(state.step), inflight=slot(state.inflight),
                      membership=mem)
