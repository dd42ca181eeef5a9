"""RMSNorm wrapper: the CUDA kernels ``csrc/rmsnorm.cu`` for CUDA tensors, the
plain versions for CPU tensors (counterpart of ``repro.kernels.rmsnorm.ops``),
and an autograd Function whose backward is the backward kernel.

Kernel vs plain, stated bounds (checked on the card by ``chip_smoke.py``):
the forwards differ only in the order of the f32 sum of squares, so in f32
``|kernel − plain| ≤ 2e-5·|plain| + 1e-6`` per element, and in bf16 at most
one bf16 ulp of the plain value (a rounding boundary may fall between them).
The backward kernel computes the closed form of the gradient while the plain
version is torch autograd of the plain forward, and dscale sums the rows in
another order: in f32 ``|Δ| ≤ 1e-5·max|plain|`` for dx and dscale; in bf16
one bf16 ulp of the plain value plus ``1e-5·max|plain|``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.rmsnorm import ref as _ref

KERNEL = Kernel("rmsnorm", {"rmsnorm_launch": [P, P, P, I, I, F, I, P]})
BWD = Kernel("rmsnorm_bwd", {"rmsnorm_bwd_launch": [P, P, P, P, P, P, I, I, F, I, I, P]}, source="rmsnorm")
BWD_BLOCKS = 264  # about two row blocks per SM of an H100 (132 SMs)


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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-5):
    """(dx, dscale) for x, dy: (rows, d); scale: (d,). New for the port."""
    if x.dim() != 2 or dy.shape != x.shape or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_bwd takes x, dy (rows, d) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, {tuple(scale.shape)}")
    if all(t.device.type == "cpu" for t in (x, scale, dy)):
        return _ref.rmsnorm_bwd(x, scale, dy, eps)
    if x.device.type != "cuda" or scale.device != x.device or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: x on {x.device}, scale on {scale.device}, dy on {dy.device}")
    if not (scale.dtype == dy.dtype == x.dtype):
        raise TypeError(f"rmsnorm_bwd: dtypes differ: x {x.dtype}, scale {scale.dtype}, dy {dy.dtype}")
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    rows, d = x.shape
    per_block = -(-rows // BWD_BLOCKS)
    partial = torch.empty((-(-rows // per_block), d), dtype=torch.float32, device=x.device)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    BWD.launch(
        "rmsnorm_bwd_launch", x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), rows, d, float(eps), per_block, dtype_code(x.dtype), stream_ptr(x.device),
    )
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """Forward kernel; backward kernel from the saved x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_2d(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Arbitrary leading dims: flatten to rows, normalise, restore.
    Differentiable through :class:`RMSNorm` when a gradient is wanted."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    if x.numel() == 0:
        return x
    x2 = x.reshape(-1, d).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x2, scale, eps).reshape(*lead, d)
    return rmsnorm_2d(x2, scale, eps=eps).reshape(*lead, d)
