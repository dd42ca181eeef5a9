"""Tree checkpointing to .npz (counterpart of ``repro.checkpoint.checkpointer``).

The file format is the reference's, key for key, so a checkpoint written by
either package restores in the other:

* each leaf is stored under its path: NamedTuple fields by name, dict keys
  (in sorted order), sequence indices, joined with ``::``; ``None`` slots
  store nothing;
* bf16 is widened to f32 (npz has no bf16) and narrowed back to the
  template's dtype on restore;
* each :class:`~repro_torch.parallel.packing.Packed` node stores its buffers
  under ``<prefix>::<bucket>`` and its layout table, as the reference's
  JSON, byte for byte, under ``<prefix>::__layout__``;
* each :class:`~repro_torch.parallel.offload.HostPlane` (an offloaded
  state's optimizer state, vars and in-flight plane) stores its chunk
  stacks, ``(num_chunks,) + lead + (chunk_elems,)``, under
  ``<prefix>::<bucket>``, and no layout, as the reference's pytree
  flattening does; it restores into a HostPlane template (pinned where the
  template's stacks are).

The sidecar makes restores across formats work as in the reference: a
packed checkpoint into a template whose subtree is per-leaf (each stored
buffer sliced by the stored slot table), a per-leaf checkpoint into a
packed template (packed with the template's layout), and the packed
optimizer's scalar step count to and from per-worker ``(m,)`` counts.
``elastic=True`` resizes the worker axis (shrink keeps the first rows, grow
seeds new rows from row 0).

One container differs between the packages: on the packed path PowerSGD's
``q`` factors are a tuple over the layout's leaves here (``None`` for an
uncompressed leaf) and a parameter-shaped dict in the reference. They are
stored under the reference's dict paths, taken from the error plane's
layout. Per leaf (``AlgoConfig.packed=False``) ``q`` is the reference's
dict, and every per-leaf state is stored and restored as the reference's.

On a worker mesh (:mod:`repro_torch.parallel.sharding`) ``save`` first
drains a state's in-flight collective (``repro_torch.training.drain``), then
gathers every row-stacked plane (a ``Packed`` node with a worker axis: x, the
optimizer's rows, PowerSGD's error, the avg-rebase x₀, the gossip mix) to
rank 0 in column chunks, bit for bit
(:func:`~repro_torch.parallel.sharding.gather_rows_exact`), into host memory
(pinned on a card), and rank 0 writes the same file the one-process ``save``
of the whole state writes; the replicated nodes (z, v, sparse_anchor's
error, the gossip w and t, q, the step) are written once. ``restore`` on a
mesh has every rank read the file and keep its rows; the in-flight value
comes back finished, and the next rank boundary consumes it as the first
one does. ``elastic=True`` resizes the stored worker axis to the mesh's m
before the rows are cut, so a one-process file restores onto W ranks, a
W-rank file into one process, and a file of W ranks onto W' at the same m.
An offloaded rank state's row-stacked host planes (the optimizer state of
the rank's rows, PowerSGD's error) are gathered one chunk of their stacks
at a time (through the mesh's device, a chunk's rows at a time: no plane
makes a whole trip to the card) and restored into pinned stacks of the
rank's rows. A per-leaf state's row-stacked leaves, which the types that
hold them declare (a NamedTuple's ``ROWS`` names its row-stacked fields:
x's, the optimizer state's with the per-worker Adam count, PowerSGD's
error, the avg-rebase x₀, the gossip mix, legacy CoCoD's round start), are
gathered leaf by leaf the same way.

With fsdp > 1, or wherever the anchor is stored as the rank's piece
(:class:`~repro_torch.parallel.sharding.Sharded`), ``save`` first makes each
share whole (every rank: the column slices gathered over the fsdp group,
the anchor pieces over both groups, the padding dropped) and then writes as
above, so the file is the one-process file at any (W, F); ``restore`` fits
the stored whole plane (rows, ``elastic``) and cuts the rank's share, so a
file restores onto any (W, F) at the same m, and across m with
``elastic=True``.

Restored leaves are tensors of the template's dtype on the template leaf's
device. This module imports numpy and torch only.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.parallel import offload as off
from repro_torch.parallel import sharding
from repro_torch.parallel.offload import HostPlane
from repro_torch.parallel.packing import Layout, Packed, tree_flatten

_SEP = "::"
_LAYOUT_KEY = "__layout__"


def _join(*parts: str) -> str:
    return _SEP.join(p for p in parts if p)


def _is_power_state(node) -> bool:
    return getattr(node, "_fields", None) == ("q", "err") and isinstance(node.q, tuple) and isinstance(node.err, Packed)


def _walk(node, prefix: str, visit: Callable[[str, Any], Any]):
    """Rebuild ``node`` with ``visit(key, leaf)`` at every tensor leaf and
    every Packed node (the reference's flatten order: NamedTuple fields,
    sorted dict keys, sequence indices; ``None`` kept as it is)."""
    if node is None:
        return None
    if isinstance(node, (Packed, HostPlane)):
        return visit(prefix, node)
    if _is_power_state(node):
        q = tuple(None if t is None else visit(_join(prefix, "q", *path), t)
                  for path, t in zip(node.err.layout.paths, node.q))
        return type(node)(q, _walk(node.err, _join(prefix, "err"), visit))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk(getattr(node, f), _join(prefix, f), visit) for f in node._fields))
    if isinstance(node, dict):
        return {k: _walk(node[k], _join(prefix, str(k)), visit) for k in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_walk(v, _join(prefix, str(i)), visit) for i, v in enumerate(node))
    return visit(prefix, node)


def _nodes(tree) -> List[Tuple[str, Any]]:
    """(key, node) for every leaf and Packed node, in flatten order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", lambda k, n: out.append((k, n)))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # npz has no bf16: widen losslessly
        t = t.float()
    return t.cpu().numpy()


def _encode_layout(layout: Layout) -> np.ndarray:
    """The reference's ``_encode_layout``: the same JSON, byte for byte."""
    payload = json.dumps(
        {
            "slots": [
                [s.index, s.bucket, list(s.shape), s.dtype, s.offset, s.size, s.stride]
                for s in layout.slots
            ],
            "bucket_dtypes": list(layout.bucket_dtypes),
            "bucket_sizes": [int(n) for n in layout.bucket_sizes],
        }
    )
    return np.frombuffer(payload.encode("utf-8"), np.uint8)


_GATHER_COLUMNS = 1 << 24  # columns of a row-stacked plane gathered at a time on a mesh


def _drained(tree):
    """A train state with its rank boundary's collective finished (the
    finished in-flight value has the one-process structure)."""
    from repro_torch.training import drain
    from repro_torch.training.train_state import TrainState

    return drain(tree) if isinstance(tree, TrainState) else tree


def _gathered(buf: torch.Tensor, mesh) -> Any:
    """All m rows of a rank's (r, n) bucket, bit for bit, on rank 0 (None on
    the others, which take part in the gathers): the column chunks gathered
    on the device and copied into one host array (pinned when the rows are
    on a card)."""
    r, n = buf.shape
    host = torch.empty((r * mesh.size, n), dtype=buf.dtype, pin_memory=buf.is_cuda) if mesh.first else None
    for j in range(0, n, _GATHER_COLUMNS):
        c = slice(j, min(n, j + _GATHER_COLUMNS))
        rows = sharding.gather_rows_exact(buf[:, c].contiguous(), mesh)
        if host is not None:
            host[:, c].copy_(rows)
    return None if host is None else _to_numpy(host)


def _stacked(node) -> bool:
    """A Packed plane (or its host form) with a worker axis (row-stacked; on
    a mesh the rank's rows)."""
    return isinstance(node, (Packed, HostPlane)) and len(node.lead_shape) == 1


def _row_leaves(tree) -> set:
    """The ids of a tree's row-stacked tensor leaves (on a mesh the rank's
    rows): every tensor under a field that its NamedTuple names in its
    ``ROWS`` — declared by the type that holds it: a per-leaf x
    (``TrainState``), the per-leaf optimizer states, PowerSGD's error, the
    avg-rebase x₀, the gossip mix, legacy CoCoD's round start. Packed and
    host planes carry their own worker axis (:func:`_stacked`)."""
    ids = set()

    def visit(node, rows: bool):
        if isinstance(node, torch.Tensor):
            if rows:
                ids.add(id(node))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            declared = getattr(type(node), "ROWS", ())
            for f in node._fields:
                visit(getattr(node, f), rows or f in declared)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v, rows)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v, rows)

    visit(tree, False)
    return ids


def _gathered_stack(stack: torch.Tensor, mesh) -> Any:
    """All m rows of a rank's host chunk stack (k, r, c), bit for bit, on
    rank 0 (None elsewhere): one chunk's rows at a time through the mesh's
    device, into one host array (k, m, c)."""
    k, r, c = stack.shape
    host = torch.empty((k, r * mesh.size, c), dtype=stack.dtype) if mesh.first else None
    for i in range(k):
        rows = sharding.gather_rows_exact(stack[i].to(mesh.device), mesh)
        if host is not None:
            host[i].copy_(rows)
    return None if host is None else _to_numpy(host)


def _arrays(tree, mesh):
    """(key, numpy array) for every stored array of ``tree`` in the file's
    order, the layout sidecars last; made one at a time, so a save holds one
    array in host memory. On a mesh every rank runs the gathers of the
    row-stacked planes and leaves and only rank 0 gets arrays (None
    elsewhere)."""
    layouts = []
    rows = _row_leaves(tree) if mesh is not None else set()
    for key, node in _nodes(tree):
        if isinstance(node, sharding.Sharded):  # every rank: the whole rows (or the whole anchor), padding dropped
            node = sharding.unshard(node, mesh)
        if mesh is not None and isinstance(node, HostPlane) and _stacked(node):  # a chunk at a time
            for i, stack in enumerate(node.host_ready().chunks):
                yield _join(key, str(i)), _gathered_stack(stack, mesh)
        elif mesh is not None and _stacked(node):  # every rank gathers, rank 0 keeps
            for i, buf in enumerate(node.buffers):
                yield _join(key, str(i)), _gathered(buf, mesh)
            layouts.append((_join(key, _LAYOUT_KEY), _encode_layout(node.layout)))
        elif id(node) in rows:
            r = node.shape[0]
            got = _gathered(node.reshape(r, -1), mesh)
            yield key, None if got is None else got.reshape((r * mesh.size,) + tuple(node.shape[1:]))
        elif mesh is not None and not mesh.first:
            continue
        elif isinstance(node, Packed):
            for i, buf in enumerate(node.buffers):
                yield _join(key, str(i)), _to_numpy(buf)
            layouts.append((_join(key, _LAYOUT_KEY), _encode_layout(node.layout)))
        elif isinstance(node, HostPlane):
            for i, stack in enumerate(node.host_ready().chunks):
                yield _join(key, str(i)), _to_numpy(stack)
        else:
            yield key, _to_numpy(node)
    yield from layouts


def _write_npz(f, items) -> None:
    """``np.savez`` of (key, array) items, written as they come: each array
    an uncompressed ``<key>.npy`` member (zip64), as numpy writes them."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors, Packed planes, NamedTuples, dicts, tuples)
    to ``path`` atomically (a ``.tmp`` file, then a rename), one array in
    host memory at a time. On a worker mesh every rank calls it: a train
    state is drained, the row-stacked planes gathered, and rank 0 writes
    the one-process file."""
    mesh = sharding.current_mesh()
    if mesh is not None:
        tree = _drained(tree)
    items = _arrays(tree, mesh)
    if mesh is None or mesh.first:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            _write_npz(f, items)
        os.replace(tmp, path)
    else:
        for _ in items:  # the gathers rank 0 waits on
            pass
    if mesh is not None:  # the file is there before any rank returns
        sharding.barrier(mesh)


class _Stored:
    """The arrays of an open ``.npz`` read when asked for (not cached), with
    entries added or popped over them: a restore holds the arrays of one
    node at a time."""

    def __init__(self, npz):
        self.npz, self.keys, self.added = npz, set(npz.files), {}

    def __contains__(self, key) -> bool:
        return key in self.added or key in self.keys

    def __getitem__(self, key):
        return self.added[key] if key in self.added else self.npz[key]

    def __setitem__(self, key, value) -> None:
        self.added[key] = value

    def __iter__(self):
        return iter(sorted(self.keys | set(self.added)))

    def pop(self, key):
        value = self[key]
        self.keys.discard(key)
        self.added.pop(key, None)
        return value


def _fit_leaf(arr: np.ndarray, shape: Tuple[int, ...], key: str, elastic: bool = False) -> np.ndarray:
    """The reference's ``_fit_leaf`` on shapes (the dtype is set later, in
    torch): the elastic worker resize and the scalar ↔ (m,) step count."""
    arr = np.asarray(arr)
    if elastic and arr.shape != shape and arr.ndim == len(shape) and arr.ndim >= 1 and arr.shape[1:] == shape[1:]:
        m_old, m_new = arr.shape[0], shape[0]
        if m_new < m_old:
            arr = arr[:m_new]
        else:
            pad = np.broadcast_to(arr[:1], (m_new - m_old,) + arr.shape[1:])
            arr = np.concatenate([arr, pad], axis=0)
    if arr.shape != shape:
        # packed scalar step count <-> per-leaf (m,) per-worker counts: the
        # workers step in lockstep, so one value describes all of them
        if shape == () and arr.ndim == 1:
            arr = arr[0]
        elif arr.shape == () and len(shape) == 1:
            arr = np.broadcast_to(arr, shape).copy()
        else:
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}; template wants {shape}")
    return arr


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device, cast on the
    host first (a card holds no widened copy of a bf16 plane)."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if t.dtype != like.dtype:
        t = t.to(like.dtype)
    return t.to(like.device)


def _expand_stored_packed(arrays: dict, layouts: dict, nodes) -> None:
    """Packed checkpoint → per-leaf template: slice each stored buffer back
    into per-leaf entries keyed by the template's leaf paths (slot order is
    the subtree's flatten order)."""
    template_packed = {p for p, n in nodes if isinstance(n, Packed)}
    for prefix, lay in layouts.items():
        if prefix in template_packed or _join(prefix, "0") not in arrays:
            continue
        key_prefix = prefix + _SEP if prefix else ""
        group = [(p, n) for p, n in nodes if p.startswith(key_prefix) and not isinstance(n, Packed)]
        slots = lay["slots"]
        if len(group) != len(slots):
            raise KeyError(
                f"packed checkpoint group {prefix!r} has {len(slots)} slots but the "
                f"template subtree has {len(group)} leaves — structures must match"
            )
        bufs = [arrays[_join(prefix, str(b))] for b in range(len(lay["bucket_sizes"]))]
        for (leaf_key, _), (_idx, bucket, shape, _dname, offset, size, _stride) in zip(group, slots):
            buf = bufs[bucket]
            lead = tuple(buf.shape[:-1])
            arrays[leaf_key] = buf[..., offset : offset + size].reshape(lead + tuple(shape))


def _pack_perleaf_into(arrays: dict, prefix: str, node: Packed) -> List[np.ndarray]:
    """Per-leaf checkpoint → packed template: gather the subtree's per-leaf
    arrays (paths from the template layout) into buffers of the template's
    layout. The lead (worker) axis is the stored arrays', so an elastic
    restore packs at the checkpoint's worker count and resizes after. bf16
    buckets are packed in f32 and narrowed with the rest."""
    lay = node.layout
    keys = [_join(prefix, *lay.paths[s.index]) for s in lay.slots]
    if keys[0] not in arrays:
        raise KeyError(f"checkpoint missing {keys[0]!r} (needed to pack {prefix or '<root>'!r})")
    a0 = np.asarray(arrays[keys[0]])
    lead = tuple(int(s) for s in a0.shape[: a0.ndim - len(lay.slots[0].shape)])
    np_dtype = {d: (np.float32 if d == "bfloat16" else np.dtype(d)) for d in lay.bucket_dtypes}
    bufs = [np.zeros(lead + (int(n),), np_dtype[d]) for d, n in zip(lay.bucket_dtypes, lay.bucket_sizes)]
    for slot, key in zip(lay.slots, keys):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key!r} (needed to pack {prefix or '<root>'!r})")
        arr = np.asarray(arrays[key]).reshape(lead + (slot.size,))
        bufs[slot.bucket][..., slot.offset : slot.offset + slot.size] = arr.astype(bufs[slot.bucket].dtype)
    return bufs


def restore(path: str, template: Any, elastic: bool = False) -> Any:
    """Rebuild ``template``'s structure from the checkpoint at ``path``, each
    leaf a tensor of the template leaf's dtype on its device. ``elastic``
    resizes the worker axis of any leaf or packed buffer whose trailing dims
    match the template (the reference's ``restore(..., elastic=True)``).
    On a worker mesh every rank calls it with its own state as the template
    (drained first): a row-stacked plane is fitted to all m = r·W workers
    and the rank keeps its rows."""
    mesh = sharding.current_mesh()
    if mesh is not None:
        template = _drained(template)
    with np.load(path) as z:
        return _restore(_Stored(z), template, elastic, mesh)


def _fit_stack(arr: np.ndarray, shape: Tuple[int, ...], key: str, elastic: bool) -> np.ndarray:
    """A stored chunk stack (k, m', c) of a row-stacked host plane fitted to
    (k, m, c): with ``elastic`` the worker axis (axis 1) resized as
    :func:`_fit_leaf` resizes axis 0."""
    arr = np.asarray(arr)
    if elastic and arr.ndim == 3 and arr.shape != shape and (arr.shape[0], arr.shape[2]) == (shape[0], shape[2]):
        arr = np.moveaxis(_fit_leaf(np.moveaxis(arr, 1, 0), (shape[1], shape[0], shape[2]), key, True), 0, 1)
    return _fit_leaf(arr, shape, key)


def _shard_of(arr, like: torch.Tensor, bucket: int, key: str, node, mesh, elastic: bool) -> torch.Tensor:
    """This rank's share of a stored whole bucket for a
    :class:`~repro_torch.parallel.sharding.Sharded` template ``node``: its
    rows (all m fitted first, ``elastic`` resizing them) and its column
    slice, or its anchor piece."""
    n = node.split.widths[bucket]
    if node.anchor:
        full = _to_tensor(_fit_leaf(arr, (n,), key), like)
    else:
        m = node.lead_shape[0] * mesh.size
        lo, hi = mesh.rows(m)
        full = _to_tensor(_fit_leaf(arr, (m, n), key, elastic)[lo:hi], like)
    return sharding.cut_to_rank(full, bucket, node.split, node.axis)


def _restore(arrays, template: Any, elastic: bool, mesh) -> Any:
    layouts = {}
    rows = _row_leaves(template) if mesh is not None else set()
    for k in list(arrays):
        if k == _LAYOUT_KEY or k.endswith(_SEP + _LAYOUT_KEY):
            prefix = "" if k == _LAYOUT_KEY else k[: -(len(_LAYOUT_KEY) + len(_SEP))]
            layouts[prefix] = json.loads(bytes(arrays.pop(k).tobytes()).decode("utf-8"))
    nodes = _nodes(template)
    _expand_stored_packed(arrays, layouts, nodes)

    def visit(key, node):
        if isinstance(node, Packed):
            bufkeys = [_join(key, str(i)) for i in range(len(node.buffers))]
            if all(k in arrays for k in bufkeys):
                stored = [arrays[k] for k in bufkeys]
            else:
                stored, bufkeys = _pack_perleaf_into(arrays, key, node), [key] * len(node.buffers)
            if isinstance(node, sharding.Sharded):  # the whole plane fitted, then this rank's share
                return node.with_buffers(tuple(_shard_of(a, b, i, k, node, mesh, elastic)
                                               for i, (a, b, k) in enumerate(zip(stored, node.buffers, bufkeys))))
            if mesh is not None and _stacked(node):  # all m rows fitted, then this rank's
                m = node.lead_shape[0] * mesh.size
                lo, hi = mesh.rows(m)
                return Packed(tuple(_to_tensor(_fit_leaf(a, (m,) + tuple(b.shape[1:]), k, elastic)[lo:hi], b)
                                    for a, b, k in zip(stored, node.buffers, bufkeys)), node.layout)
            return Packed(tuple(_to_tensor(_fit_leaf(a, tuple(b.shape), k, elastic), b)
                                for a, b, k in zip(stored, node.buffers, bufkeys)), node.layout)
        if isinstance(node, HostPlane):
            stacks = []
            for i, like in enumerate(node.chunks):
                k = _join(key, str(i))
                if k not in arrays:
                    raise KeyError(f"checkpoint missing {k!r}")
                shape = tuple(like.shape)
                if _stacked(node):  # all m rows fitted (elastic: the worker axis), then this rank's
                    lo, hi = (0, shape[1]) if mesh is None else mesh.rows(shape[1] * mesh.size)
                    arr = _fit_stack(arrays[k], (shape[0], hi - lo if mesh is None else shape[1] * mesh.size,
                                                 shape[2]), k, elastic)[:, lo:hi]
                else:
                    arr = _fit_leaf(arrays[k], shape, k)
                stack = off._host_stack(shape, like.dtype, pinned=like.is_pinned())
                stacks.append(stack.copy_(_to_tensor(arr, like)))
            return HostPlane(stacks, node.layout, node.plan, node.device)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key!r}")
        if id(node) in rows:  # a row-stacked leaf: all m rows fitted, then this rank's
            m = node.shape[0] * mesh.size
            lo, hi = mesh.rows(m)
            return _to_tensor(_fit_leaf(arrays[key], (m,) + tuple(node.shape[1:]), key, elastic)[lo:hi], node)
        return _to_tensor(_fit_leaf(arrays[key], tuple(node.shape), key, elastic), node)

    return _walk(template, "", visit)
