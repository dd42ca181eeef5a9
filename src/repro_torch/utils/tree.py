"""Small arithmetic over nested dicts of tensors (counterpart of
``repro.utils.tree``), dtype-preserving as the reference's helpers are.

The reference multiplies by a Python scalar as a JAX *weakly typed*
constant: rounded to the tensor's dtype first, so a bf16 leaf scaled by 0.3
is multiplied by ``bfloat16(0.3)``. A scalar here is rounded the same way
(:func:`repro_torch.kernels.opt_step.ref.weak`). A scalar given as a tensor
is strongly typed, as a JAX array is: the product runs in the promoted
dtype and is cast back. Every product and sum is its own op, so each
rounds on its own.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.opt_step.ref import weak
from repro_torch.parallel.packing import tree_flatten


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _times(x: torch.Tensor, s) -> torch.Tensor:
    """``s * x`` as JAX computes it: a Python scalar weakly typed (in x's
    dtype), a tensor in the promoted dtype."""
    if isinstance(s, torch.Tensor):
        dt = torch.promote_types(x.dtype, s.dtype)
        return x.to(dt) * s.to(dt)
    return weak(s, x.dtype) * x


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: _times(x, s).to(x.dtype), a)


def tree_axpy(s, x, y):
    """y + s * x, elementwise over the tree, in y's dtypes."""
    return tree_map(lambda xi, yi: (yi + _times(xi, s)).to(yi.dtype), x, y)


def tree_lerp(a, b, alpha):
    """(1 - alpha) * a + alpha * b (the paper's pullback mixing, eq. 4), in
    a's dtypes."""
    one_minus = 1.0 - alpha
    return tree_map(lambda ai, bi: (_times(ai, one_minus) + _times(bi, alpha)).to(ai.dtype), a, b)


def tree_dot(a, b):
    """Σ over the leaves of ⟨a, b⟩ in float32 (0-dim); the sums run in
    PyTorch's order, not XLA's."""
    total = 0.0
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        total = total + torch.dot(x.float().reshape(-1), y.float().reshape(-1))
    return total


def tree_l2_norm(tree):
    return torch.sqrt(tree_dot(tree, tree))
