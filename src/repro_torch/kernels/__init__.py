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
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return [rms_ops.KERNEL, rms_ops.BWD, pa_ops.ATTEND, pa_ops.APPEND, opt_ops.SGD, opt_ops.ADAMW, opt_ops.SGD_WINDOW,
            opt_ops.ADAMW_WINDOW, am_ops.MIX, am_ops.MIX_ROWS,
            am_ops.GOSSIP, am_ops.GOSSIP_RANK, am_ops.MEAN, am_ops.MOMENTUM, am_ops.MEAN_RANK, am_ops.MOMENTUM_RANK, fa_ops.FWD,
            fa_ops.BWD_DQ, fa_ops.BWD_DKDV,
            fa_ops.BWD_DKDV_SUM, probe_ops.PROBE, probe_ops.PROBE_RANK, wkv_ops.FWD_LOCAL, wkv_ops.FWD,
            wkv_ops.BWD_LOCAL, wkv_ops.BWD,
            ssd_ops.FWD_LOCAL, ssd_ops.FWD, ssd_ops.BWD_LOCAL, ssd_ops.BWD]
