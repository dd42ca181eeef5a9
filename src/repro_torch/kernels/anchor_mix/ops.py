"""Round-boundary wrappers (K5 ``anchor_mix`` and its gossip form
``gossip_boundary_``, K4 ``pullback_mean``, K3 ``pullback_mean_momentum``
and their rank form ``pullback_rank``):
the CUDA kernels of ``csrc/anchor_mix.cu`` for CUDA tensors, the plain
versions of ``ref.py`` for CPU tensors (counterpart of
``repro.kernels.anchor_mix.ops``).

x (and K3's momentum v) are updated **in place** and returned; the new
anchor (K4's mean, K3's ``z_next``) gets a buffer of its own, so the
consumed anchor ``z`` stays intact (the strategy keeps it as ``vars.z``).
K5 takes x and z of one shape (any shape, contiguous) and needs no padding:
the reference pads a flat buffer to 128 lanes, the kernel masks its tail.
Its row form takes a worker-stacked x ``(m, *s)`` and one z of shape ``s``
for every row (the per-leaf pullback, which the reference runs as K5
vmapped over the workers): one launch, each CTA reading its z tile once for
all m rows; it counts on :data:`MIX_ROWS`, the same-shape launch on
:data:`MIX`.
The rank form (:func:`pullback_rank`) is K3/K4 on one rank's rows when the
worker axis is spread over ``torch.distributed`` ranks: it finishes the
anchor from the all-reduced f32 worker sum of the last boundary (a mean, or
a membership's weighted sum), pulls the rows back (dead rows pass through
under the rows' weights) and leaves their f32 partial sum (weighted, or of
the pre-pullback rows for EASGD) in the wire buffer for the next
all-reduce; it counts on :data:`MOMENTUM_RANK` (K3) or :data:`MEAN_RANK`
(K4).
The gossip form runs the push-sum boundary of one bucket (debias, K5 on the
rows that move, the push ``Peff @ x'``) in one launch, x and the in-flight
mix in place; it counts on :data:`GOSSIP`, a count of its own. Its rank form
(:func:`gossip_rank_`) runs it on one rank's rows when the push is a
neighbour exchange: the mix formed from the held launch-time rows (the
rank's own copy and the received rows), the debias and K5, and the new
launch-time copy, in one launch a bucket; it counts on :data:`GOSSIP_RANK`.

``probe=True`` adds the consensus probe of adaptive τ to K3/K4: the
``[drift_sq, scale_sq]`` raw sums of the *pre-pullback* x over all m rows
(unweighted, dead rows included, masked or not), computed inside the same
launch by K8's device functions (:mod:`repro_torch.kernels.consensus_probe`)
and returned as a third (K4) or fourth (K3) output, a (2,) float32 tensor.

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
bitwise, in f32 and bf16 — both sum the worker axis in float32 in the order
0 .. m-1, divide by m, and round after every op at the same points (the
gossip form's push likewise sums k = 0 .. m-1 in order). The
probe output: as K8's (``consensus_probe/ops.py``), and bit for bit the
standalone K8's on the same pre-boundary plane.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, L, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.anchor_mix import ref as _ref
from repro_torch.kernels.consensus_probe import ops as _probe
from repro_torch.kernels.consensus_probe.ref import plane_probe

_MIX_ARGS = {"anchor_mix_launch": [P, P, I, L, L, L, F, F, I, P]}
MIX = Kernel("anchor_mix", _MIX_ARGS, source="anchor_mix")
# the row form (z broadcast over the rows of a worker-stacked x), counted apart
MIX_ROWS = Kernel("anchor_mix_rows", _MIX_ARGS, source="anchor_mix")
GOSSIP = Kernel("gossip_boundary", {"gossip_boundary_launch": [P, P, P, P, P, I, L, F, F, I, P]},
                source="anchor_mix")
GOSSIP_RANK = Kernel("gossip_rank", {"gossip_rank_launch": [P, P, P, P, P, P, P, P, I, I, I, I, I, L, F, F, I, I, P]},
                     source="anchor_mix")
MEAN = Kernel("pullback_mean", {"pullback_mean_launch": [P, P, P, P, I, L, F, F, I, P, P, P, I, P]},
              source="anchor_mix")
MOMENTUM = Kernel(
    "pullback_momentum", {"pullback_momentum_launch": [P, P, P, P, P, I, L, F, F, F, P, P, P, I, P]},
    source="anchor_mix",
)
# K3/K4's rank form (one launch body), each counted on its own
_RANK_ARGS = {"pullback_rank_launch": [P, P, P, P, P, P, I, L, I, F, F, F, I, I, I, P]}
MOMENTUM_RANK = Kernel("pullback_momentum_rank", _RANK_ARGS, source="anchor_mix")
MEAN_RANK = Kernel("pullback_mean_rank", _RANK_ARGS, source="anchor_mix")


def anchor_mix(x, z, alpha: float):
    """Eq. (4), x ← (1−α)·x + α·z, in place on x. z has x's shape, or x is
    worker-stacked ``(m, *s)`` and z of shape ``s`` is the one anchor of
    every row (the row form). One dtype and device. Replaces
    ``anchor_mix/kernel.py::anchor_mix_flat`` (vmapped over the workers in
    the row form). Returns x."""
    rows_form = z.shape != x.shape
    if ((rows_form and (x.dim() == 0 or z.shape != x.shape[1:])) or z.dtype != x.dtype
            or z.get_device() != x.get_device()):
        raise ValueError(f"anchor_mix: z must match x {tuple(x.shape)} (or its rows) {x.dtype} on {x.device}, "
                         f"got {tuple(z.shape)} {z.dtype} on {z.device}")
    if x.is_cpu:
        if not z.is_cpu:
            raise ValueError(f"anchor_mix: z must match x on {x.device}, got {z.device}")
        return x.copy_(_ref.anchor_mix(x, z, alpha))
    if not x.is_cuda:
        raise ValueError(f"anchor_mix: unsupported device {x.device}")
    if not (x.is_contiguous() and z.is_contiguous()):
        raise ValueError("anchor_mix: CUDA buffers must be contiguous")
    if rows_form:
        kernel, rows, width, ldz = MIX_ROWS, x.shape[0], z.numel(), 0
    else:
        kernel, rows, width, ldz = MIX, 1, x.numel(), x.numel()
    kernel.launch("anchor_mix_launch", x.data_ptr(), z.data_ptr(), rows, width, width, ldz, float(1.0 - alpha),
                  float(alpha), dtype_code(x.dtype), stream_ptr(x.device))
    return x


def gossip_boundary_(x, mix, wsafe, live, peff, alpha: float):
    """The push-sum gossip boundary of one bucket, in place on x and mix
    (both (m, n), one dtype): z = mix / wsafe, x ← (1−α)·x + α·z on the rows
    with ``live > 0``, then mix ← Peff @ x. wsafe, live: (m,) float32;
    peff: (m, m) float32. K5 fused with the reference's debias and push
    (``GossipPushSumStrategy._packed_boundary``); the kernel picks its
    layout from m and the dtype (``csrc/anchor_mix.cu``). Returns (x, mix)."""
    if x.dim() != 2 or mix.shape != x.shape or mix.dtype != x.dtype:
        raise ValueError(f"gossip_boundary_: x and mix must be (m, n) of one dtype, got {tuple(x.shape)} "
                         f"{x.dtype} and {tuple(mix.shape)} {mix.dtype}")
    m = x.shape[0]
    f32 = torch.float32
    if (wsafe.shape != (m,) or live.shape != (m,) or peff.shape != (m, m)
            or wsafe.dtype != f32 or live.dtype != f32 or peff.dtype != f32):
        raise ValueError(f"gossip_boundary_: wsafe, live ({m},) and peff ({m}, {m}) must be float32")
    if x.is_cpu and mix.is_cpu and wsafe.is_cpu and live.is_cpu and peff.is_cpu:
        x_new, mix_new = _ref.gossip_boundary(x, mix, wsafe, live, peff, alpha)
        x.copy_(x_new)
        mix.copy_(mix_new)
        return x, mix
    index = x.get_device()
    if not x.is_cuda or any(t.get_device() != index for t in (mix, wsafe, live, peff)):
        raise ValueError(f"gossip_boundary_: tensors on mixed or unsupported devices: {x.device}, {mix.device}, "
                         f"{wsafe.device}, {live.device}, {peff.device}")
    if not all(t.is_contiguous() for t in (x, mix, wsafe, live, peff)):
        raise ValueError("gossip_boundary_: CUDA buffers must be contiguous")
    GOSSIP.launch("gossip_boundary_launch", x.data_ptr(), mix.data_ptr(), wsafe.data_ptr(), live.data_ptr(),
                  peff.data_ptr(), m, x.shape[1], float(1.0 - alpha), float(alpha), dtype_code(x.dtype),
                  stream_ptr(x.device))
    return x, mix


_HELD = {}  # (held, received, lo, r, device) -> the (2, h) int32 table on that device


def _held_table(held, received, lo: int, r: int, device) -> torch.Tensor:
    """The held rows' (source, global index) table: source k >= 0 is row k
    of the received rows, < 0 own row -1-k. Built once a schedule and device."""
    key = (tuple(held), tuple(received), lo, r, str(device))
    if key not in _HELD:
        src = [j - lo if lo <= j < lo + r else received.index(j) for j in held]
        src = [-1 - s if lo <= j < lo + r else s for s, j in zip(src, held)]
        _HELD[key] = torch.tensor([src, list(held)], dtype=torch.int32, device=device)
    return _HELD[key]


def gossip_rank_(x, own, recv, held, received, lo: int, peff, wsafe, live, alpha: float, mode: int = 0):
    """K5's gossip rank form on one rank's rows of one bucket, in place:
    x (r, n) the rows ``[lo, lo + r)`` and own (r, n) their launch-time
    copy, one dtype; recv (len(received), n) the received rows (``None``
    when none); ``held`` every row the mix reads (global indices,
    ascending: own and received); peff (m, m), wsafe and live (r,) float32.
    mode 0: mix_i = Σ_k Peff[lo + i, held_k]·held_k in f32, k in order;
    mode 1: own holds the finished mix; then z = mix / wsafe, x ← (1−α)·x
    + α·z on the rows with ``live > 0``, own ← x. mode 2 (the drain): own ←
    the mix, x unchanged. The plain version is ``ref.gossip_rank``. Returns
    (x, own)."""
    r, n = x.shape if x.dim() == 2 else (-1, -1)
    if r < 1 or own.shape != x.shape or own.dtype != x.dtype:
        raise ValueError(f"gossip_rank_: x and own must be (r, n) of one dtype, got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(own.shape)} {own.dtype}")
    if recv is not None and (recv.dim() != 2 or recv.shape[1] != n or recv.dtype != x.dtype):
        raise ValueError(f"gossip_rank_: recv must be (h, {n}) {x.dtype}, got {tuple(recv.shape)} {recv.dtype}")
    hr = 0 if recv is None else recv.shape[0]
    m = peff.shape[0] if peff.dim() == 2 else -1
    f32 = torch.float32
    if (peff.shape != (m, m) or wsafe.shape != (r,) or live.shape != (r,) or peff.dtype != f32
            or wsafe.dtype != f32 or live.dtype != f32):
        raise ValueError(f"gossip_rank_: peff (m, m), wsafe and live ({r},) must be float32")
    if (len(received) != hr or list(held) != sorted(set(held)) or not set(range(lo, lo + r)) <= set(held)
            or set(held) - set(range(lo, lo + r)) != set(received) or lo < 0 or lo + r > m or mode not in (0, 1, 2)):
        raise ValueError(f"gossip_rank_: held {held} must be the rows {lo}..{lo + r - 1} and the received rows "
                         f"{received}, ascending, within m={m}; mode 0, 1 or 2 (got {mode})")
    tensors = (x, own, peff, wsafe, live) + (() if recv is None else (recv,))
    if all(t.is_cpu for t in tensors):
        x_new, own_new = _ref.gossip_rank(x, own, recv, held, received, lo, peff, wsafe, live, alpha, mode)
        if mode != 2:
            x.copy_(x_new)
        own.copy_(own_new)
        return x, own
    index = x.get_device()
    if not x.is_cuda or any(t.get_device() != index for t in tensors):
        raise ValueError("gossip_rank_: tensors on mixed or unsupported devices: "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gossip_rank_: CUDA buffers must be contiguous")
    if mode == 1:  # own holds the mix: the held rows are the rank's own
        held, received, recv = tuple(range(lo, lo + r)), (), None
    table = _held_table(held, received, lo, r, x.device)
    h = len(held)
    # past 16 held rows the kernel reads own while it writes the mix: a buffer of its own
    out = own if mode != 2 or h <= 16 else torch.empty_like(own)
    GOSSIP_RANK.launch("gossip_rank_launch", x.data_ptr(), own.data_ptr(), 0 if recv is None else recv.data_ptr(),
                       out.data_ptr(), table.data_ptr(), peff.data_ptr(), wsafe.data_ptr(), live.data_ptr(), r, h, m,
                       lo, held.index(lo), n, float(1.0 - alpha), float(alpha), mode, dtype_code(x.dtype),
                       stream_ptr(x.device))
    if out is not own:
        own.copy_(out)
    return x, own


def pullback_tree(x_tree, z_tree, alpha: float):
    """:func:`anchor_mix` on every leaf of two nested dicts of one
    structure (the per-leaf pullback), x's leaves in place: one launch a
    leaf. x's leaves are worker-stacked ``(m, *s)``; z's leaves are
    unstacked ``s`` (one anchor for all workers: the row form, the
    reference's ``_pullback``) or stacked like x (a worker's own anchor:
    gossip's debiased mix)."""
    if isinstance(x_tree, dict):
        return {k: pullback_tree(x_tree[k], z_tree[k], alpha) for k in x_tree}
    return anchor_mix(x_tree, z_tree, alpha)


def _check(name, x, vecs, weights):
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (m, n), got {tuple(x.shape)}")
    for t in vecs:
        if t.shape != (x.shape[1],) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: anchor buffers must be ({x.shape[1]},) {x.dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if weights is not None and (weights.shape != (x.shape[0],) or weights.dtype != torch.float32
                                or weights.device != x.device):
        raise ValueError(f"{name}: weights must be ({x.shape[0]},) float32 on {x.device}")
    if x.device.type == "cuda":
        if not all(t.is_contiguous() for t in (x, *vecs)) or (weights is not None and not weights.is_contiguous()):
            raise ValueError(f"{name}: CUDA buffers must be contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _wptr(weights) -> int:
    return 0 if weights is None else weights.data_ptr()


def _probe_args(x, probe: bool):
    """(stats or None, the three probe pointers: zeros without a probe)."""
    if not probe:
        return None, (0, 0, 0)
    return _probe.probe_args(x)


def pullback_mean(x, z, alpha: float, mean_pre: bool = False, probe: bool = False, weights=None):
    """Eq. (4) + worker mean. x: (m, n) pulled back in place; z: (n,).
    Replaces ``anchor_mix/kernel.py::pullback_mean_flat``. Returns (x, mean),
    with ``probe`` (x, mean, stats)."""
    _check("pullback_mean", x, (z,), weights)
    if x.device.type == "cpu":
        stats = plane_probe(x) if probe else None
        x_new, mean = _ref.pullback_mean(x, z, alpha, mean_pre=mean_pre, weights=weights)
        x.copy_(x_new)
        return (x, mean, stats) if probe else (x, mean)
    mean = torch.empty_like(z)
    stats, pp = _probe_args(x, probe)
    MEAN.launch(
        "pullback_mean_launch", x.data_ptr(), z.data_ptr(), _wptr(weights), mean.data_ptr(), x.shape[0],
        x.shape[1], float(1.0 - alpha), float(alpha), int(bool(mean_pre)), *pp, dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return (x, mean, stats) if probe else (x, mean)


def pullback_mean_momentum(x, z, v, alpha: float, beta: float, probe: bool = False, weights=None):
    """Eq. (4) + eqs. (10)-(11). x: (m, n) and v: (n,) updated in place; z:
    (n,) the consumed anchor, left as it is. Replaces
    ``anchor_mix/kernel.py::pullback_momentum_flat``. Returns (x, z_next, v),
    with ``probe`` (x, z_next, v, stats)."""
    _check("pullback_mean_momentum", x, (z, v), weights)
    if x.device.type == "cpu":
        stats = plane_probe(x) if probe else None
        x_new, z_next, v_new = _ref.pullback_mean_momentum(x, z, v, alpha, beta, weights=weights)
        x.copy_(x_new)
        v.copy_(v_new)
        return (x, z_next, v, stats) if probe else (x, z_next, v)
    z_next = torch.empty_like(z)
    stats, pp = _probe_args(x, probe)
    MOMENTUM.launch(
        "pullback_momentum_launch", x.data_ptr(), z.data_ptr(), v.data_ptr(), _wptr(weights), z_next.data_ptr(),
        x.shape[0], x.shape[1], float(1.0 - alpha), float(alpha), float(beta), *pp, dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return (x, z_next, v, stats) if probe else (x, z_next, v)


def pullback_rank(x, z, v, s, m: int, alpha: float, beta, finish, weights=None, mean_pre: bool = False):
    """K3 (``v`` given) or K4 (``v`` None) on one rank's rows: with
    ``finish``, the anchor z' from ``s``, the f32 worker sum of the last
    boundary over all ``m`` workers (``finish == 2``: a weighted sum, taken
    as the mean with no division; K3: v updated in place); then the rows
    of x (r, n; r may be 0, the drain) pulled back in place toward z' (toward
    z without ``finish``) and their f32 partial sum written over ``s``:
    with ``weights`` ((r,) float32, the rows' membership weights) dead rows
    pass through and the sum is Σ w_i·x_i; with ``mean_pre`` it is of the
    pre-pullback rows. z, v: (n,) of x's dtype; s: (n,) float32. Returns z'
    (a new buffer), or z itself without ``finish``."""
    finish = int(finish)
    _check("pullback_rank", x, (z,) if v is None else (z, v), weights)
    if s.shape != (x.shape[1],) or s.dtype != torch.float32 or s.device != x.device:
        raise ValueError(f"pullback_rank: s must be ({x.shape[1]},) float32 on {x.device}, got {tuple(s.shape)} "
                         f"{s.dtype} on {s.device}")
    if m < 1 or finish not in (0, 1, 2) or (v is not None and beta is None):
        raise ValueError(f"pullback_rank: m must be >= 1, finish 0, 1 or 2, and K3 needs beta, got m={m}, "
                         f"finish={finish}, beta={beta}")
    if x.device.type == "cpu":
        x_new, z_next, v_new, partial = _ref.pullback_rank(x, z, v, s, m, alpha, beta, finish, weights, mean_pre)
        x.copy_(x_new)
        if v_new is not None:
            v.copy_(v_new)
        if partial is not None:
            s.copy_(partial)
        return z_next
    if not s.is_contiguous():
        raise ValueError("pullback_rank: CUDA buffers must be contiguous")
    z_next = torch.empty_like(z) if finish else z
    kernel = MEAN_RANK if v is None else MOMENTUM_RANK
    kernel.launch(
        "pullback_rank_launch", x.data_ptr(), z.data_ptr(), 0 if v is None else v.data_ptr(), _wptr(weights),
        s.data_ptr(), z_next.data_ptr() if finish else 0, x.shape[0], x.shape[1], int(m), float(1.0 - alpha),
        float(alpha), float(beta or 0.0), finish, int(bool(mean_pre)), dtype_code(x.dtype), stream_ptr(x.device),
    )
    return z_next
