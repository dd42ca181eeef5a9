"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
only for CPU tensors; nothing reroutes a CUDA tensor to the plain path.
:func:`all_kernels` lists every kernel with its launch counter.
"""
from __future__ import annotations


def all_kernels():
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return [rms_ops.KERNEL, pa_ops.ATTEND, pa_ops.APPEND]
