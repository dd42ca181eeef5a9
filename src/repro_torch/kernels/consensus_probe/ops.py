"""Consensus-probe wrappers (counterpart of
``repro.kernels.consensus_probe.ops``): K8 ``consensus_probe_launch`` of
``csrc/anchor_mix.cu`` for CUDA tensors, the plain version of ``ref.py`` for
CPU tensors.

``probe_buffer`` measures one worker-stacked buffer (one launch);
``packed_probe`` sweeps a whole :class:`~repro_torch.parallel.packing.Packed`
plane (one launch a dtype bucket); ``stats_from_partials`` pools per-bucket
raw sums, also those K3/K4 emit with ``probe=True``, into the controller's
:class:`ConsensusStats`. Everything stays on the device: the stats are
0-dim float32 tensors, read by the host once a round with the losses.

``probe_rows`` is K8's rank form (the worker axis over ranks): one rank's
rows against the global f32 column mean, the float64 sums returned for the
ranks' float64 sum (:func:`repro_torch.core.strategy.rank_probe`).

The kernel keeps a float64 workspace (one pair a block) and an unsigned
counter per device, allocated at its first launch there and shared with the
fused probe of K3/K4; launches on one device are ordered by its current
stream, which the round engine uses throughout.

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
the two sums within rtol 1e-6 at the classifier's plane — the kernel adds
the squares in float64 over its grid, the plain version in float32 in
PyTorch's order; on larger planes against a float64 sum of the same squares.
The kernel's result is the same bits from run to run, and the fused output
of K3/K4 equals the standalone kernel's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels._build import I, L, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.consensus_probe import ref as _ref
from repro_torch.parallel.packing import Packed, tree_flatten

PROBE = Kernel("consensus_probe", {"consensus_probe_launch": [P, I, L, P, P, P, I, P]}, source="anchor_mix")
# K8's rank form (one rank's rows against the global mean), counted apart
PROBE_RANK = Kernel("consensus_probe_rank", {"consensus_probe_rank_launch": [P, I, L, P, P, P, P, I, P]},
                    source="anchor_mix")
MAX_BLOCKS = 132 * 16  # kMaxBlocks in csrc/anchor_mix.cu: the workspace holds one pair a block

_WORKSPACES = {}


class ConsensusStats(NamedTuple):
    """The controller's two inputs, 0-dim float32 tensors:
    drift = mean_i ‖x_i − x̄‖ (RMS-aggregated), scale = ‖x̄‖."""

    drift: torch.Tensor
    scale: torch.Tensor


def workspace(device: torch.device):
    """The probe's (2·MAX_BLOCKS,) float64 workspace and its zeroed counter
    on ``device``, made once."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (torch.empty(2 * MAX_BLOCKS, dtype=torch.float64, device=device),
                            torch.zeros(1, dtype=torch.int32, device=device))
    return _WORKSPACES[key]


def probe_args(x: torch.Tensor):
    """(out, workspace, counter) pointers of a probe on ``x``'s device; out
    is a new (2,) float32 tensor, returned first."""
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    ws, counter = workspace(x.device)
    return out, (out.data_ptr(), ws.data_ptr(), counter.data_ptr())


def probe_buffer(x: torch.Tensor) -> torch.Tensor:
    """x: (m, n) stacked buffer → (2,) float32 ``[drift_sq, scale_sq]`` raw
    sums (not yet divided by m). One launch of K8 on the GPU. Replaces
    ``consensus_probe/kernel.py::probe_flat``; needs no padding: the kernel
    takes any n."""
    if x.dim() != 2:
        raise ValueError(f"probe_buffer: x must be (m, n), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ref.plane_probe(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe_buffer: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("probe_buffer: CUDA buffers must be contiguous")
    out, (po, pw, pc) = probe_args(x)
    PROBE.launch("consensus_probe_launch", x.data_ptr(), x.shape[0], x.shape[1], po, pw, pc, dtype_code(x.dtype),
                 stream_ptr(x.device))
    return out


def probe_rows(x: torch.Tensor, xbar: torch.Tensor) -> torch.Tensor:
    """K8's rank form: x (r, n), one rank's rows, and ``xbar`` (n,) float32,
    the global column mean over all m workers → (2,) float64
    ``[drift_sq over the rows, scale_sq]``, the sums not rounded to f32 (the
    ranks add their drift sums in float64). One launch on the GPU."""
    if x.dim() != 2 or xbar.shape != (x.shape[1],) or xbar.dtype != torch.float32 or xbar.device != x.device:
        raise ValueError(f"probe_rows: x must be (r, n) and xbar (n,) float32 on x's device, got {tuple(x.shape)} "
                         f"and {tuple(xbar.shape)} {xbar.dtype} on {xbar.device}")
    if x.device.type == "cpu":
        return _ref.rows_probe(x, xbar)
    if x.device.type != "cuda":
        raise ValueError(f"probe_rows: unsupported device {x.device}")
    if not (x.is_contiguous() and xbar.is_contiguous()):
        raise ValueError("probe_rows: CUDA buffers must be contiguous")
    out = torch.empty(2, dtype=torch.float64, device=x.device)
    ws, counter = workspace(x.device)
    PROBE_RANK.launch("consensus_probe_rank_launch", x.data_ptr(), x.shape[0], x.shape[1], xbar.data_ptr(),
                      out.data_ptr(), ws.data_ptr(), counter.data_ptr(), dtype_code(x.dtype), stream_ptr(x.device))
    return out


def stats_from_partials(partials, m: int) -> ConsensusStats:
    """Pool per-bucket ``[drift_sq, scale_sq]`` raw sums into (drift, scale):
    the pooled drift divided by the worker count once, then square roots."""
    drift_sq = sum(p[0] for p in partials)
    scale_sq = sum(p[1] for p in partials)
    m_t = torch.full((), float(m), dtype=torch.float32, device=drift_sq.device)
    return ConsensusStats(torch.sqrt(drift_sq / m_t), torch.sqrt(scale_sq))


def packed_probe(px: Packed) -> ConsensusStats:
    """Standalone probe of a worker-stacked plane: one K8 launch a bucket."""
    m = int(px.lead_shape[0]) if px.lead_shape else 1
    return stats_from_partials([probe_buffer(b) for b in px.buffers], m)


def tree_probe(x_stacked) -> ConsensusStats:
    """The per-leaf form over a nested dict of worker-stacked leaves (the
    semantics of :func:`repro_torch.control.consensus_drift`), in plain
    PyTorch."""
    drift_sq, scale_sq = 0.0, 0.0
    for t in tree_flatten(x_stacked)[0]:
        tf = t.float()
        mean = torch.mean(tf, dim=0, keepdim=True)
        drift_sq = drift_sq + torch.sum(torch.square(tf - mean)) / t.shape[0]
        scale_sq = scale_sq + torch.sum(torch.square(mean))
    return ConsensusStats(torch.sqrt(drift_sq), torch.sqrt(scale_sq))
