"""Normalization layers (counterpart of ``repro.models.layers.norms``):
RMSNorm and the bias-free LayerNorm.

``rmsnorm`` goes through the K7 wrapper, which launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors. ``layernorm``
(command-r's parallel blocks) is plain torch on either device, as the
reference computes it outside any Pallas kernel, op for op its cast chain:
the statistics and the normalised row in f32, the scale in f32, one cast
back to the input dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ops as rms_ops


def init_rmsnorm(b, name: str, dim: int):
    with b.scope(name):
        b.param("scale", (dim,), init="ones")


def rmsnorm(params, x, eps: float = 1e-5):
    return rms_ops.rmsnorm(x, params["scale"], eps=eps)


def init_layernorm(b, name: str, dim: int):
    with b.scope(name):
        b.param("scale", (dim,), init="ones")


def layernorm(params, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)
