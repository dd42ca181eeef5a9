"""Fused optimizer-step wrappers (K1 ``sgd_step``, K2 ``adamw_step``): the CUDA
kernels of ``csrc/opt_step.cu`` for CUDA tensors, the plain versions of
``ref.py`` for CPU tensors (counterpart of ``repro.kernels.opt_step.ops``).

Both update **in place**: the parameter buffer and the optimizer state are
overwritten and returned (the reference returns new arrays). ``lr`` (and
AdamW's ``c1``, ``c2``) are f32 tensors of one element on the buffers'
device; the kernels read them from device memory, so a step needs no host
synchronisation.

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
bitwise, in f32 and bf16 — both round after every op at the same points,
the kernel through ``__f*_rn`` intrinsics that nvcc never contracts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, L, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.opt_step import ref as _ref

SGD = Kernel("sgd_step", {"sgd_step_launch": [P, P, P, P, L, F, F, I, I, I, P]}, source="opt_step")
ADAMW = Kernel(
    "adamw_step", {"adamw_step_launch": [P, P, P, P, P, L, F, F, F, F, F, F, I, I, P]}, source="opt_step"
)


def _check(name, x, others, scalars):
    for t in others:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: buffers must share shape and device, got {tuple(t.shape)}@{t.device} "
                             f"vs {tuple(x.shape)}@{x.device}")
    for s in scalars:
        if s.numel() != 1 or s.dtype != torch.float32 or s.device != x.device:
            raise ValueError(f"{name}: lr/c1/c2 must be one-element float32 tensors on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _cuda_ready(name, tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA buffers must be contiguous")


def sgd_step(x, g, m, lr, *, momentum: float, nesterov: bool, weight_decay: float):
    """SGD (+Nesterov) on one bucket, in place. x, g, m: (w, n) of one dtype.
    Replaces ``opt_step/kernel.py::sgd_step_flat``. Returns (x, m)."""
    _check("sgd_step", x, (g, m), (lr,))
    if g.dtype != x.dtype or m.dtype != x.dtype:
        raise TypeError(f"sgd_step: x, g, m must share a dtype, got {x.dtype}, {g.dtype}, {m.dtype}")
    if x.device.type == "cpu":
        x_new, m_new = _ref.sgd_update(x, g, m, lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
        x.copy_(x_new)
        m.copy_(m_new)
        return x, m
    _cuda_ready("sgd_step", (x, g, m))
    SGD.launch(
        "sgd_step_launch", x.data_ptr(), g.data_ptr(), m.data_ptr(), lr.data_ptr(), x.numel(),
        _ref.weak(momentum, x.dtype), _ref.weak(weight_decay, x.dtype), int(bool(weight_decay)),
        int(bool(nesterov)), dtype_code(x.dtype), stream_ptr(x.device),
    )
    return x, m


def adamw_step(x, g, mu, nu, lr, c1, c2, *, b1: float, b2: float, eps: float, weight_decay: float):
    """AdamW on one bucket, in place. x, g: (w, n) parameter dtype; mu, nu:
    (w, n) f32. Replaces ``opt_step/kernel.py::adamw_step_flat``. Returns
    (x, mu, nu)."""
    _check("adamw_step", x, (g, mu, nu), (lr, c1, c2))
    if g.dtype != x.dtype or mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise TypeError(f"adamw_step: g must match x ({x.dtype}) and mu, nu be float32")
    if x.device.type == "cpu":
        x_new, mu_new, nu_new = _ref.adamw_update(
            x, g, mu, nu, lr, c1, c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay
        )
        x.copy_(x_new)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        return x, mu, nu
    _cuda_ready("adamw_step", (x, g, mu, nu))
    scalars = torch.cat([lr.reshape(1), c1.reshape(1), c2.reshape(1)])
    f32 = torch.float32
    ADAMW.launch(
        "adamw_step_launch", x.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), scalars.data_ptr(),
        x.numel(), _ref.weak(b1, f32), _ref.weak(1 - b1, f32), _ref.weak(b2, f32), _ref.weak(1 - b2, f32),
        _ref.weak(eps, f32), _ref.weak(weight_decay, f32), int(bool(weight_decay)), dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return x, mu, nu
