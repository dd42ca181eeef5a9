"""Plain PyTorch consensus probe, op for op the reference
``repro.kernels.consensus_probe.ref.plane_probe`` (counterpart; K8 in
``csrc/anchor_mix.cu`` computes the same sums).

The probe reads the round-end (pre-boundary) worker-stacked plane: how far
the workers drifted apart over the round, and how large the consensus model
is. The sums are raw: ``ops.stats_from_partials`` divides the pooled drift by
m once, across the dtype buckets.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.anchor_mix.ref import worker_mean


def plane_probe(x: torch.Tensor) -> torch.Tensor:
    """x: (m, n) worker-stacked buffer. Returns a (2,) float32 tensor
    ``[drift_sq, scale_sq]``: Σ (x_i − x̄)² over all workers and elements and
    Σ x̄² over elements, with x̄ the f32 worker mean (rows summed in order,
    as K8 sums them)."""
    xf = x.float()
    mean = worker_mean(xf)
    return torch.stack([torch.sum(torch.square(xf - mean[None, :])), torch.sum(torch.square(mean))])


def rows_probe(x: torch.Tensor, xbar: torch.Tensor) -> torch.Tensor:
    """K8's rank form: one rank's rows x (r, n) and the global f32 column
    mean ``xbar`` (n,). Returns a (2,) float64 tensor ``[drift_sq, scale_sq]``:
    Σ (x_i − x̄)² over the rows and elements and Σ x̄² over elements, each
    square rounded to float32 and the squares added in float64 (K8's sums),
    so that the ranks' drift sums add in float64."""
    xf = x.float()
    return torch.stack([torch.sum(torch.square(xf - xbar[None, :]).double()),
                        torch.sum(torch.square(xbar.float()).double())])
