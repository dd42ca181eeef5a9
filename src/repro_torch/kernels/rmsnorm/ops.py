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

import functools

import torch

from repro_torch.kernels._build import F, I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.rmsnorm import ref as _ref

KERNEL = Kernel("rmsnorm", {"rmsnorm_launch": [P, P, P, I, I, F, I, I, I, P]})
BWD = Kernel("rmsnorm_bwd", {"rmsnorm_bwd_launch": [P, P, P, P, P, P, I, I, F, I, I, I, P]}, source="rmsnorm")
BWD_BLOCKS = 264  # the block kernel's row blocks: about two per SM of an H100 (132 SMs)
SMS = 132  # the sub-warp backward's row blocks: one 1024-thread CTA per SM
NARROW_D = 1024  # rows of at most this many elements go to a sub-warp, wider ones to a CTA
WIDE_THREADS = 512  # the most threads a CTA gives one wide row
BWD_THREADS = 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def plan(d: int, elem: int) -> tuple:
    """``(lanes, vecs)``: how the forward kernel lays a row of ``d``
    elements of ``elem`` bytes over its threads, each thread holding at most
    ``vecs`` (1, 2, 4 or 8) 16-byte vectors of the row in registers.

    * ``lanes`` ≤ 32 (d ≤ 1024): a sub-warp of ``lanes`` lanes, a power of
      two, a row; 256 // lanes rows a CTA.
    * ``lanes`` > 32: one CTA of ``lanes`` threads (a multiple of 32, at most
      512) a row, chosen where it can so that the row's vectors divide evenly
      (3584 bf16 = 448 vectors: 448 threads of one).
    * ``(0, 0)``: the block-per-row kernel (d not a multiple of the vector,
      or a row of more than 8 vectors a thread)."""
    per = 16 // elem
    if d % per:
        return 0, 0
    nv = d // per
    if d <= NARROW_D:
        lanes = min(32, _pow2_at_least(nv))
        return lanes, _pow2_at_least(-(-nv // lanes))
    for vecs in (1, 2, 4, 8):
        threads = nv // vecs
        if nv % vecs == 0 and threads % 32 == 0 and threads <= WIDE_THREADS:
            return threads, vecs
    vecs = _pow2_at_least(-(-nv // WIDE_THREADS))
    if vecs > 8:
        return 0, 0
    per_thread = -(-nv // vecs)
    return 32 * -(-per_thread // 32), vecs  # the last warp's tail lanes idle


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, d: int, elem: int) -> tuple:
    """``(lanes, rows_per_block)`` for the backward. Rows of at most 32
    16-byte vectors: a sub-warp of ``lanes`` lanes a row, one vector a lane,
    1024 // lanes rows at a time over a block's range, about one block an SM
    (``rows_per_block`` a multiple of the sub-warps a block). Wider rows:
    ``lanes`` 0, the block kernel over ``BWD_BLOCKS`` row blocks. The
    partial rows number ``ceil(rows / rows_per_block)`` either way."""
    per = 16 // elem
    if d % per == 0 and d // per <= 32:
        lanes = _pow2_at_least(d // per)
        groups = BWD_THREADS // lanes
        return lanes, groups * -(-rows // (groups * SMS))
    return 0, -(-rows // BWD_BLOCKS)


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, d); scale: (d,). Replaces ``rmsnorm/kernel.py::rmsnorm_2d``."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_2d takes x (rows, d) and scale (d,), got {tuple(x.shape)}, {tuple(scale.shape)}")
    return _forward(x, scale, eps)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward over x's last dimension, whatever its leading ones: the
    kernel reads a contiguous x as rows of d, so no reshape is needed."""
    if x.is_cpu and scale.is_cpu:
        return _ref.rmsnorm(x, scale, eps)
    if not x.is_cuda or scale.get_device() != x.get_device():
        raise ValueError(f"rmsnorm_2d: x on {x.device}, scale on {scale.device}")
    if scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm_2d: scale dtype {scale.dtype} != x dtype {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_2d: x and scale must be contiguous")
    code = dtype_code(x.dtype)
    out = torch.empty_like(x)
    n, d = x.numel(), scale.shape[0]
    if n:
        KERNEL.launch("rmsnorm_launch", x.data_ptr(), scale.data_ptr(), out.data_ptr(), n // d, d, eps, code,
                      *plan(d, x.element_size()), stream_ptr(x.device))
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-5):
    """(dx, dscale) for x, dy: (rows, d); scale: (d,). New for the port."""
    if x.dim() != 2 or dy.shape != x.shape or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_bwd takes x, dy (rows, d) and scale (d,), got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}, {tuple(scale.shape)}")
    if x.is_cpu and scale.is_cpu and dy.is_cpu:
        return _ref.rmsnorm_bwd(x, scale, dy, eps)
    index = x.get_device()
    if not x.is_cuda or scale.get_device() != index or dy.get_device() != index:
        raise ValueError(f"rmsnorm_bwd: x on {x.device}, scale on {scale.device}, dy on {dy.device}")
    if not (scale.dtype == dy.dtype == x.dtype):
        raise TypeError(f"rmsnorm_bwd: dtypes differ: x {x.dtype}, scale {scale.dtype}, dy {dy.dtype}")
    code = dtype_code(x.dtype)
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    rows, d = x.shape
    lanes, per_block = bwd_plan(rows, d, x.element_size())
    partial = torch.empty((-(-rows // per_block), d), dtype=torch.float32, device=x.device)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    BWD.launch(
        "rmsnorm_bwd_launch", x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partial.data_ptr(), rows, d, eps, lanes, per_block, code, stream_ptr(x.device),
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
    """Arbitrary leading dims: normalise over the last one. Differentiable
    through :class:`RMSNorm` (on x flattened to rows) when a gradient is
    wanted; otherwise the forward reads x in place of a reshape."""
    if scale.dim() != 1 or x.dim() == 0 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm takes x (..., d) and scale (d,), got {tuple(x.shape)}, {tuple(scale.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        if x.numel() == 0:
            return x
        return RMSNorm.apply(x.reshape(-1, x.shape[-1]).contiguous(), scale, eps).view(x.shape)
    return _forward(x if x.is_contiguous() else x.contiguous(), scale, eps)
