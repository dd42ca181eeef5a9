"""Packed parameter plane: one flat buffer per dtype, static layout table
(counterpart of ``repro.parallel.packing``).

The m workers' parameters live as one contiguous ``(m, n)`` tensor per dtype
bucket. Optimizer state (SGD momentum, AdamW f32 moments) and anchor-shaped
state (z, v, the in-flight anchor) are planes of the same layout, so a local
step is one fused kernel launch per bucket and a round boundary one more,
whatever the number of leaves.

Layout rules, kept exactly as in the reference so that a JAX plane and a
port plane of the same tree are the same bytes:

* leaves are bucketed by dtype name, buckets in sorted name order;
* within a bucket, leaves keep the reference's flatten order (nested dicts
  by sorted key);
* each leaf starts at a 128-element-aligned ``offset`` and occupies
  ``stride = ceil(size / 128) * 128`` elements; the padding is zero.

The 128 is the TPU lane width in the reference. Here it keeps the planes of
the two packages byte-identical, and it keeps every leaf 512-byte aligned
in f32 (256 in bf16), which suits 16-byte vector loads.

Unlike the reference, :func:`unpack` and :func:`view_leaf` return *views*
of the plane, not copies: writing to one writes to the plane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

LANE = 128


def _round_up(n: int, mult: int = LANE) -> int:
    return ((n + mult - 1) // mult) * mult


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (the reference's ``jnp.dtype(d).name``)."""
    return str(dtype).split(".")[-1]


def tree_flatten(tree, path: Tuple[str, ...] = ()) -> Tuple[list, Tuple[Tuple[str, ...], ...]]:
    """Leaves of a nested dict in the reference's flatten order (sorted keys,
    depth first) and their key paths (the port's tree definition)."""
    if isinstance(tree, dict):
        leaves, paths = [], []
        for k in sorted(tree):
            lv, ps = tree_flatten(tree[k], path + (k,))
            leaves += lv
            paths += ps
        return leaves, tuple(paths)
    return [tree], (path,)


def tree_unflatten(paths: Tuple[Tuple[str, ...], ...], leaves) -> dict:
    """Inverse of :func:`tree_flatten`: nested dicts from key paths."""
    out: dict = {}
    for p, leaf in zip(paths, leaves):
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Static placement of one leaf inside its dtype bucket."""

    index: int  # position in flatten order (across all buckets)
    bucket: int
    shape: Tuple[int, ...]  # without the stacked lead dims
    dtype: str
    offset: int  # element offset inside the bucket buffer
    size: int
    stride: int  # padded extent


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where every leaf of a tree lives in the packed plane. Hashable."""

    paths: Tuple[Tuple[str, ...], ...]  # key path of each leaf, flatten order
    slots: Tuple[LeafSlot, ...]
    bucket_dtypes: Tuple[str, ...]  # sorted
    bucket_sizes: Tuple[int, ...]  # padded elements per bucket

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_dtypes)

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    def with_dtype(self, dtype: torch.dtype) -> "Layout":
        """Same offsets, every slot retagged to ``dtype`` (f32 shadows such
        as the AdamW moments, element-aligned with the parameter plane)."""
        name = dtype_name(dtype)
        return Layout(
            paths=self.paths,
            slots=tuple(dataclasses.replace(s, dtype=name) for s in self.slots),
            bucket_dtypes=tuple(name for _ in self.bucket_dtypes),
            bucket_sizes=self.bucket_sizes,
        )


class Packed:
    """Per-dtype flat buffers plus their layout. ``buffers[b]`` has shape
    ``lead + (layout.bucket_sizes[b],)``; ``lead`` is e.g. the worker axis."""

    __slots__ = ("buffers", "layout")

    def __init__(self, buffers, layout: Layout):
        self.buffers = tuple(buffers)
        self.layout = layout

    @property
    def lead_shape(self) -> Tuple[int, ...]:
        return tuple(self.buffers[0].shape[:-1]) if self.buffers else ()

    def with_buffers(self, buffers, layout: Optional[Layout] = None) -> "Packed":
        """A plane of the same kind over ``buffers`` (``layout``, or this
        plane's): a rank's share of a plane stays one
        (:class:`repro_torch.parallel.sharding.Sharded`)."""
        return Packed(buffers, layout or self.layout)

    def __repr__(self):
        shapes = ", ".join(f"{tuple(b.shape)}:{self.layout.bucket_dtypes[i]}" for i, b in enumerate(self.buffers))
        return f"Packed([{shapes}], {self.layout.num_leaves} leaves)"


def layout_of(tree, lead: int = 0) -> Layout:
    """The layout table of ``tree``; ``lead`` leading dims of every leaf
    (e.g. the stacked worker axis) are not part of it."""
    leaves, paths = tree_flatten(tree)
    shapes = [tuple(int(s) for s in l.shape[lead:]) for l in leaves]
    dtypes = [dtype_name(l.dtype) for l in leaves]
    bucket_dtypes = tuple(sorted(set(dtypes)))
    bucket_index = {d: i for i, d in enumerate(bucket_dtypes)}
    offsets = [0] * len(bucket_dtypes)
    slots = []
    for i, (shape, dname) in enumerate(zip(shapes, dtypes)):
        b = bucket_index[dname]
        size = math.prod(shape)
        stride = _round_up(max(size, 1))
        slots.append(LeafSlot(index=i, bucket=b, shape=shape, dtype=dname, offset=offsets[b], size=size, stride=stride))
        offsets[b] += stride
    return Layout(paths=paths, slots=tuple(slots), bucket_dtypes=bucket_dtypes, bucket_sizes=tuple(offsets))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def pack(tree, layout: Optional[Layout] = None, lead: int = 0) -> Packed:
    """Copy ``tree`` into a new zero-padded plane. The first ``lead`` dims of
    every leaf become the buffers' lead shape."""
    if layout is None:
        layout = layout_of(tree, lead=lead)
    leaves, _ = tree_flatten(tree)
    lead_shape = tuple(leaves[0].shape[:lead]) if (leaves and lead) else ()
    device = leaves[0].device if leaves else "cpu"
    buffers = [
        torch.zeros(lead_shape + (n,), dtype=_dtype(d), device=device)
        for n, d in zip(layout.bucket_sizes, layout.bucket_dtypes)
    ]
    for slot, leaf in zip(layout.slots, leaves):
        buffers[slot.bucket][..., slot.offset : slot.offset + slot.size].copy_(leaf.reshape(lead_shape + (slot.size,)))
    return Packed(buffers, layout)


def view_leaf(packed: Packed, index: int) -> torch.Tensor:
    """One leaf (by flatten index) as a view of the plane: ``lead + shape``."""
    slot = packed.layout.slots[index]
    seg = packed.buffers[slot.bucket][..., slot.offset : slot.offset + slot.size]
    return seg.view(packed.lead_shape + slot.shape)


def leaf_views(packed: Packed) -> List[torch.Tensor]:
    """Every leaf as a view of the plane, in flatten order."""
    return [view_leaf(packed, i) for i in range(packed.layout.num_leaves)]


def unpack(packed: Packed) -> dict:
    """The nested-dict tree of leaf views (padding dropped, no copy)."""
    return tree_unflatten(packed.layout.paths, leaf_views(packed))


def param_view(packed: Packed) -> dict:
    """The model's parameter tree over a plane with no lead axis (the
    reference's ``ParamView``): nested dicts whose leaves are views of the
    plane's buffers (:func:`unpack`), so a model reads its weights straight
    from the plane, with no copy."""
    if packed.lead_shape != ():
        raise ValueError(f"param_view takes a plane with no lead axis, got lead {packed.lead_shape}")
    return unpack(packed)


def packed_like(packed: Packed, fill: float = 0.0, dtype: Optional[torch.dtype] = None) -> Packed:
    """A new plane of the same layout, kind and buffer shapes, filled with
    ``fill`` (retagged to ``dtype`` when given — see
    :meth:`Layout.with_dtype`)."""
    layout = packed.layout if dtype is None else packed.layout.with_dtype(dtype)
    device = packed.buffers[0].device
    buffers = tuple(
        torch.full(tuple(b.shape), fill, dtype=_dtype(d), device=device)
        for b, d in zip(packed.buffers, layout.bucket_dtypes)
    )
    return packed.with_buffers(buffers, layout)


def buffer_map(fn: Callable, *packeds: Packed, layout: Optional[Layout] = None) -> Packed:
    """Apply ``fn`` bucket by bucket across planes of one bucket structure."""
    out = tuple(fn(*bufs) for bufs in zip(*(p.buffers for p in packeds)))
    return Packed(out, layout or packeds[0].layout)


def tensors_of(x) -> list:
    """The buffers of a plane, or the leaves of a nested dict of tensors (a
    per-leaf state), in flatten order."""
    return list(x.buffers) if isinstance(x, Packed) else tree_flatten(x)[0]


def column_chunks(b: torch.Tensor, max_elems: int = 1 << 26):
    """Column slices of an (m, n) tensor, each at most ``max_elems``
    elements in all: the windows over which a plane- or leaf-wide expression
    runs, so its f32 temporaries stay bounded whatever the tensor's size."""
    m, n = b.shape
    step = max(1, max_elems // max(m, 1))
    for c0 in range(0, n, step):
        yield slice(c0, min(n, c0 + step))


def leaf_segments(layout: Layout, bucket: int) -> Tuple[LeafSlot, ...]:
    """The slots of ``bucket``, in offset order."""
    return tuple(s for s in layout.slots if s.bucket == bucket)
