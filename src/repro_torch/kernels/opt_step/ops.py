"""Fused optimizer-step wrappers (K1 ``sgd_step``, K2 ``adamw_step``): the CUDA
kernels of ``csrc/opt_step.cu`` for CUDA tensors, the plain versions of
``ref.py`` for CPU tensors (counterpart of ``repro.kernels.opt_step.ops``).

Both update **in place**: the parameter buffer and the optimizer state are
overwritten and returned (the reference returns new arrays). ``lr`` (and
AdamW's ``c1``, ``c2``) are f32 tensors of one element on the buffers'
device; the kernels read them from device memory, so a step needs no host
synchronisation.

``sgd_step_window`` and ``adamw_step_window`` apply the same update to a
window: the rows of a column slice ``[:, c0:c0 + w]`` of an (m, n) bucket of
x and g against a staged optimizer-state chunk of another row stride, which
is how host offload's streamed step (:func:`repro_torch.parallel.offload.streamed_update`)
updates one chunk at a time. The same kernel body serves both; each form
counts its own launches (``SGD``/``SGD_WINDOW``, ``ADAMW``/``ADAMW_WINDOW``).

Kernel vs plain, stated bound (checked on the card by ``chip_smoke.py``):
bitwise, in f32 and bf16 — both round after every op at the same points,
the kernel through ``__f*_rn`` intrinsics that nvcc never contracts. The
window form equals the whole-plane form on the same elements bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, L, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.opt_step import ref as _ref

_SGD_ARGS = {"sgd_step_launch": [P, P, P, P, L, L, L, L, F, F, I, I, I, P]}
_ADAMW_ARGS = {"adamw_step_launch": [P, P, P, P, P, P, P, L, L, L, L, F, F, F, F, F, F, I, I, P]}
SGD = Kernel("sgd_step", _SGD_ARGS, source="opt_step")
ADAMW = Kernel("adamw_step", _ADAMW_ARGS, source="opt_step")
# the same entry points on a window (the streamed step of host offload), counted apart
SGD_WINDOW = Kernel("sgd_step_window", _SGD_ARGS, source="opt_step")
ADAMW_WINDOW = Kernel("adamw_step_window", _ADAMW_ARGS, source="opt_step")


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


def _whole(x):
    """The launch geometry of a whole contiguous buffer: one row of its size."""
    n = x.numel()
    return 1, n, n, n


def _window(name, x, g, states):
    """``(rows, width, ldx, lds)`` of a window: x and g 1-D or 2-D of one
    shape and one row stride ``ldx``, the state buffers of another, ``lds``;
    the last dim of each contiguous."""
    tensors = (x, g, *states)
    if x.dim() not in (1, 2) or any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: a window is 1-D or 2-D with a contiguous last dim")
    if g.stride() != x.stride() or any(s.stride() != states[0].stride() for s in states):
        raise ValueError(f"{name}: g must share x's strides, and the state buffers one another's")
    width = x.shape[-1]
    if x.dim() == 1:
        return 1, width, width, width
    return x.shape[0], width, x.stride(0), states[0].stride(0)


def sgd_step(x, g, m, lr, *, momentum: float, nesterov: bool, weight_decay: float):
    """SGD (+Nesterov) on one bucket, in place. x, g, m: (w, n) of one dtype.
    Replaces ``opt_step/kernel.py::sgd_step_flat``. Returns (x, m)."""
    return _sgd(SGD, "sgd_step", x, g, m, lr, momentum, nesterov, weight_decay)


def sgd_step_window(x, g, m, lr, *, momentum: float, nesterov: bool, weight_decay: float):
    """:func:`sgd_step` on a window, in place: x and g (rows, w) views of one
    row stride (a column slice of a bucket), m a (rows, w) view of another
    (a staged chunk). Returns (x, m)."""
    return _sgd(SGD_WINDOW, "sgd_step_window", x, g, m, lr, momentum, nesterov, weight_decay)


def _sgd(kernel, name, x, g, m, lr, momentum, nesterov, weight_decay):
    on_cpu = _on_cpu(name, x, (g, m), (lr,))
    if g.dtype != x.dtype or m.dtype != x.dtype:
        raise TypeError(f"{name}: x, g, m must share a dtype, got {x.dtype}, {g.dtype}, {m.dtype}")
    if on_cpu:
        x_new, m_new = _ref.sgd_update(x, g, m, lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
        x.copy_(x_new)
        m.copy_(m_new)
        return x, m
    if kernel is SGD:
        _cuda_ready(name, (x, g, m))
        dims = _whole(x)
    else:
        dims = _window(name, x, g, (m,))
    kernel.launch(
        "sgd_step_launch", x.data_ptr(), g.data_ptr(), m.data_ptr(), lr.data_ptr(), *dims,
        _ref.weak(momentum, x.dtype), _ref.weak(weight_decay, x.dtype), int(bool(weight_decay)),
        int(bool(nesterov)), dtype_code(x.dtype), stream_ptr(x.device),
    )
    return x, m


def adamw_step(x, g, mu, nu, lr, c1, c2, *, b1: float, b2: float, eps: float, weight_decay: float):
    """AdamW on one bucket, in place. x, g: (w, n) parameter dtype; mu, nu:
    (w, n) f32. Replaces ``opt_step/kernel.py::adamw_step_flat``. Returns
    (x, mu, nu). The kernel reads lr, c1 and c2 where they lie: one launch,
    nothing allocated."""
    return _adamw(ADAMW, "adamw_step", x, g, mu, nu, lr, c1, c2, b1, b2, eps, weight_decay)


def adamw_step_window(x, g, mu, nu, lr, c1, c2, *, b1: float, b2: float, eps: float, weight_decay: float):
    """:func:`adamw_step` on a window, in place: x and g (rows, w) views of
    one row stride, mu and nu (rows, w) f32 views of another. Returns
    (x, mu, nu)."""
    return _adamw(ADAMW_WINDOW, "adamw_step_window", x, g, mu, nu, lr, c1, c2, b1, b2, eps, weight_decay)


def _adamw(kernel, name, x, g, mu, nu, lr, c1, c2, b1, b2, eps, weight_decay):
    on_cpu = _on_cpu(name, x, (g, mu, nu), (lr, c1, c2))
    if g.dtype != x.dtype or mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise TypeError(f"{name}: g must match x ({x.dtype}) and mu, nu be float32")
    if on_cpu:
        x_new, mu_new, nu_new = _ref.adamw_update(
            x, g, mu, nu, lr, c1, c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay
        )
        x.copy_(x_new)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        return x, mu, nu
    if kernel is ADAMW:
        _cuda_ready(name, (x, g, mu, nu))
        dims = _whole(x)
    else:
        dims = _window(name, x, g, (mu, nu))
    weak, f32 = _ref.weak, torch.float32
    kernel.launch(
        "adamw_step_launch", x.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), lr.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), *dims, weak(b1, f32), weak(1 - b1, f32), weak(b2, f32),
        weak(1 - b2, f32), weak(eps, f32), weak(weight_decay, f32), int(bool(weight_decay)), dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return x, mu, nu
