"""RMSNorm wrapper: the CUDA kernel ``csrc/rmsnorm.cu`` for CUDA tensors, the
plain version for CPU tensors (counterpart of ``repro.kernels.rmsnorm.ops``).

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
the two differ only in the order of the f32 sum of squares, so in f32
``|kernel − plain| ≤ 2e-5·|plain| + 1e-6`` per element, and in bf16 at most
one bf16 ulp of the plain value (a rounding boundary may fall between them).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.rmsnorm import ref as _ref

KERNEL = Kernel("rmsnorm", {"rmsnorm_launch": [P, P, P, I, I, F, I, P]})


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, d); scale: (d,). Replaces ``rmsnorm/kernel.py::rmsnorm_2d``."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d takes x (rows, d) and scale (d,), got {tuple(x.shape)}, {tuple(scale.shape)}")
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return _ref.rmsnorm(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm_2d: x on {x.device}, scale on {scale.device}")
    if scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm_2d: scale dtype {scale.dtype} != x dtype {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_2d: x and scale must be contiguous")
    out = torch.empty_like(x)
    KERNEL.launch(
        "rmsnorm_launch", x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], float(eps), dtype_code(x.dtype), stream_ptr(x.device),
    )
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Arbitrary leading dims: flatten to rows, normalise, restore."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    if x.numel() == 0:
        return x
    return rmsnorm_2d(x.reshape(-1, d).contiguous(), scale, eps=eps).reshape(*lead, d)
