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

Restored leaves are tensors of the template's dtype on the template leaf's
device. This module imports numpy and torch only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.parallel import offload as off
from repro_torch.parallel import sharding
from repro_torch.parallel.offload import HostPlane
from repro_torch.parallel.packing import Layout, Packed

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


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors, Packed planes, NamedTuples, dicts, tuples)
    to ``path`` atomically (a ``.tmp`` file, then a rename). Not on a
    worker mesh (ROADMAP item 10b)."""
    if sharding.current_mesh() is not None:
        raise sharding.unsupported_on_ranks("the checkpointer")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays, layouts = {}, {}
    for key, node in _nodes(tree):
        if isinstance(node, Packed):
            for i, buf in enumerate(node.buffers):
                arrays[_join(key, str(i))] = _to_numpy(buf)
            layouts[_join(key, _LAYOUT_KEY)] = _encode_layout(node.layout)
        elif isinstance(node, HostPlane):
            for i, stack in enumerate(node.host_ready().chunks):
                arrays[_join(key, str(i))] = _to_numpy(stack)
        else:
            arrays[key] = _to_numpy(node)
    arrays.update(layouts)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


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
    t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=like.device, dtype=like.dtype)


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
    Not on a worker mesh (ROADMAP item 10b)."""
    if sharding.current_mesh() is not None:
        raise sharding.unsupported_on_ranks("the checkpointer")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    layouts = {}
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
            return Packed(tuple(_to_tensor(_fit_leaf(a, tuple(b.shape), k, elastic), b)
                                for a, b, k in zip(stored, node.buffers, bufkeys)), node.layout)
        if isinstance(node, HostPlane):
            stacks = []
            for i, like in enumerate(node.chunks):
                k = _join(key, str(i))
                if k not in arrays:
                    raise KeyError(f"checkpoint missing {k!r}")
                stack = off._host_stack(tuple(like.shape), like.dtype, pinned=like.is_pinned())
                stacks.append(stack.copy_(_to_tensor(_fit_leaf(arrays[k], tuple(like.shape), k), like)))
            return HostPlane(stacks, node.layout, node.plan, node.device)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key!r}")
        return _to_tensor(_fit_leaf(arrays[key], tuple(node.shape), key, elastic), node)

    return _walk(template, "", visit)
