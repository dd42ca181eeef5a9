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
    "adamw_step", {"adamw_step_launch": [P, P, P, P, P, P, P, L, F, F, F, F, F, F, I, I, P]}, source="opt_step"
)


def _on_cpu(name, x, others, scalars) -> bool:
    """Checks the buffers' shapes and the scalars, then the devices: True if
    every tensor is on the CPU, False if all are on x's CUDA device; raises
    ValueError otherwise."""
    shape = x.shape
    for t in others:
        if t.shape != shape:
            raise ValueError(f"{name}: buffers must share shape and device, got {tuple(t.shape)}@{t.device} "
                             f"vs {tuple(shape)}@{x.device}")
    for s in scalars:
        if s.numel() != 1 or s.dtype != torch.float32:
            raise ValueError(f"{name}: lr/c1/c2 must be one-element float32 tensors on {x.device}")
    if x.is_cpu:
        if all(t.is_cpu for t in others) and all(s.is_cpu for s in scalars):
            return True
    elif x.is_cuda:
        index = x.get_device()
        if all(t.get_device() == index for t in others) and all(s.get_device() == index for s in scalars):
            return False
    else:
        raise ValueError(f"{name}: unsupported device {x.device}")
    raise ValueError(f"{name}: buffers, lr/c1/c2 must share x's device {x.device}")


def _cuda_ready(name, tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA buffers must be contiguous")


def sgd_step(x, g, m, lr, *, momentum: float, nesterov: bool, weight_decay: float):
    """SGD (+Nesterov) on one bucket, in place. x, g, m: (w, n) of one dtype.
    Replaces ``opt_step/kernel.py::sgd_step_flat``. Returns (x, m)."""
    on_cpu = _on_cpu("sgd_step", x, (g, m), (lr,))
    if g.dtype != x.dtype or m.dtype != x.dtype:
        raise TypeError(f"sgd_step: x, g, m must share a dtype, got {x.dtype}, {g.dtype}, {m.dtype}")
    if on_cpu:
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
    (x, mu, nu). The kernel reads lr, c1 and c2 where they lie: one launch,
    nothing allocated."""
    on_cpu = _on_cpu("adamw_step", x, (g, mu, nu), (lr, c1, c2))
    if g.dtype != x.dtype or mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise TypeError(f"adamw_step: g must match x ({x.dtype}) and mu, nu be float32")
    if on_cpu:
        x_new, mu_new, nu_new = _ref.adamw_update(
            x, g, mu, nu, lr, c1, c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay
        )
        x.copy_(x_new)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        return x, mu, nu
    _cuda_ready("adamw_step", (x, g, mu, nu))
    weak, f32 = _ref.weak, torch.float32
    ADAMW.launch(
        "adamw_step_launch", x.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), lr.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), x.numel(), weak(b1, f32), weak(1 - b1, f32), weak(b2, f32),
        weak(1 - b2, f32), weak(eps, f32), weak(weight_decay, f32), int(bool(weight_decay)), dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return x, mu, nu
