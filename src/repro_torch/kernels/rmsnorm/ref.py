"""Plain PyTorch RMSNorm, op for op the reference ``repro.kernels.rmsnorm.ref``:
f32 upcast, mean of squares, division by ``sqrt``, scale in f32, one cast
back to the input dtype."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf / torch.sqrt(ms + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)
