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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5):
    """(dx, dscale): torch autograd of :func:`rmsnorm` (the plain version of
    the backward kernel; the reference defines no backward of its own)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sg = scale.detach().requires_grad_(True)
        dx, dscale = torch.autograd.grad(rmsnorm(xg, sg, eps), (xg, sg), dy)
    return dx, dscale
