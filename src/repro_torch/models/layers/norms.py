"""RMSNorm layer (counterpart of ``repro.models.layers.norms``).

``rmsnorm`` goes through the K7 wrapper, which launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels.rmsnorm import ops as rms_ops


def init_rmsnorm(b, name: str, dim: int):
    with b.scope(name):
        b.param("scale", (dim,), init="ones")


def rmsnorm(params, x, eps: float = 1e-5):
    return rms_ops.rmsnorm(x, params["scale"], eps=eps)
