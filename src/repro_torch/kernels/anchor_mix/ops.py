"""Round-boundary wrappers (K5 ``anchor_mix``, K4 ``pullback_mean``, K3
``pullback_mean_momentum``): the CUDA kernels of ``csrc/anchor_mix.cu`` for
CUDA tensors, the plain versions of ``ref.py`` for CPU tensors (counterpart
of ``repro.kernels.anchor_mix.ops``).

x (and K3's momentum v) are updated **in place** and returned; the new
anchor (K4's mean, K3's ``z_next``) gets a buffer of its own, so the
consumed anchor ``z`` stays intact (the strategy keeps it as ``vars.z``).
K5 takes x and z of one shape (any shape, contiguous) and needs no padding:
the reference pads a flat buffer to 128 lanes, the kernel masks its tail.

``probe=True`` adds the consensus probe of adaptive τ to K3/K4: the
``[drift_sq, scale_sq]`` raw sums of the *pre-pullback* x over all m rows
(unweighted, dead rows included, masked or not), computed inside the same
launch by K8's device functions (:mod:`repro_torch.kernels.consensus_probe`)
and returned as a third (K4) or fourth (K3) output, a (2,) float32 tensor.

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
bitwise, in f32 and bf16 — both sum the worker axis in float32 in the order
0 .. m-1, divide by m, and round after every op at the same points. The
probe output: as K8's (``consensus_probe/ops.py``), and bit for bit the
standalone K8's on the same pre-boundary plane.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, L, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.anchor_mix import ref as _ref
from repro_torch.kernels.consensus_probe import ops as _probe
from repro_torch.kernels.consensus_probe.ref import plane_probe

MIX = Kernel("anchor_mix", {"anchor_mix_launch": [P, P, L, F, F, I, P]}, source="anchor_mix")
MEAN = Kernel("pullback_mean", {"pullback_mean_launch": [P, P, P, P, I, L, F, F, I, P, P, P, I, P]},
              source="anchor_mix")
MOMENTUM = Kernel(
    "pullback_momentum", {"pullback_momentum_launch": [P, P, P, P, P, I, L, F, F, F, P, P, P, I, P]},
    source="anchor_mix",
)


def anchor_mix(x, z, alpha: float):
    """Eq. (4), x ← (1−α)·x + α·z, in place on x; x and z of one shape,
    dtype and device. Replaces ``anchor_mix/kernel.py::anchor_mix_flat``.
    Returns x."""
    if z.shape != x.shape or z.dtype != x.dtype or z.device != x.device:
        raise ValueError(f"anchor_mix: z must match x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(z.shape)} {z.dtype} on {z.device}")
    if x.device.type == "cpu":
        return x.copy_(_ref.anchor_mix(x, z, alpha))
    if x.device.type != "cuda":
        raise ValueError(f"anchor_mix: unsupported device {x.device}")
    if not (x.is_contiguous() and z.is_contiguous()):
        raise ValueError("anchor_mix: CUDA buffers must be contiguous")
    MIX.launch("anchor_mix_launch", x.data_ptr(), z.data_ptr(), x.numel(), float(1.0 - alpha), float(alpha),
               dtype_code(x.dtype), stream_ptr(x.device))
    return x


def pullback_tree(x_tree, z_tree, alpha: float):
    """:func:`anchor_mix` on every leaf of two nested dicts of one
    structure (the per-leaf pullback), x's leaves in place."""
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
