"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs the plain version
only for CPU tensors; nothing reroutes a CUDA tensor to the plain path.
:func:`all_kernels` lists every kernel with its launch counter.
"""
from __future__ import annotations


def all_kernels():
    from repro_torch.kernels.anchor_mix import ops as am_ops
    from repro_torch.kernels.consensus_probe import ops as probe_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.opt_step import ops as opt_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return [rms_ops.KERNEL, rms_ops.BWD, pa_ops.ATTEND, pa_ops.APPEND, opt_ops.SGD, opt_ops.ADAMW, am_ops.MIX,
            am_ops.MEAN, am_ops.MOMENTUM, fa_ops.FWD, fa_ops.BWD_DQ, fa_ops.BWD_DKDV, probe_ops.PROBE]
