"""Plain PyTorch optimizer steps over flat buffers, op for op the reference
``repro.kernels.opt_step.ref`` (counterpart; the CUDA kernels in
``csrc/opt_step.cu`` compute the same chain).

The rounding points are the reference's, which JAX's type promotion sets:

* A Python scalar is *weakly typed* in JAX: ``momentum * m`` with bf16 ``m``
  multiplies by ``bfloat16(momentum)`` and rounds to bf16. PyTorch would
  multiply by the float32 value, so :func:`weak` rounds the constant to the
  tensor's dtype first.
* ``lr`` (and Adam's ``c1``, ``c2``) are *strongly typed* f32 arrays in JAX,
  so ``x - lr * u`` runs in f32 even for bf16 ``x`` and is cast back once.
  In PyTorch a 0-dim f32 tensor times a bf16 tensor gives bf16, so the
  upcast is written out.
* Every op rounds on its own (no fused multiply-add), and division by a
  scalar is a true division: ``c1``/``c2`` stay tensors, which PyTorch
  divides by elementwise rather than by a rounded reciprocal.

Padding lanes stay zero: g = m = x = 0 gives u = 0 (AdamW: nu = 0 gives
0 / (0 + eps) = 0), so x stays 0.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def weak(c: float, dtype: torch.dtype) -> float:
    """The Python scalar ``c`` as JAX's weakly typed constant in ``dtype``:
    rounded to that dtype (exactly representable in float32 and float64).
    Cached: the wrappers ask for the same few constants every step."""
    return torch.tensor(c, dtype=dtype).item()


def sgd_update(x, g, m, lr, *, momentum: float, nesterov: bool, weight_decay: float):
    """One SGD (+Nesterov momentum) step. x, g, m: same-shape buffers; lr: f32
    tensor of one element. Returns new (x, m)."""
    if weight_decay:
        g = g + weak(weight_decay, g.dtype) * x.to(g.dtype)
    m_new = (weak(momentum, m.dtype) * m + g).to(m.dtype)
    u = weak(momentum, m_new.dtype) * m_new + g if nesterov else m_new
    x_new = (x.float() - lr * u.float()).to(x.dtype)
    return x_new, m_new


def adamw_update(x, g, mu, nu, lr, c1, c2, *, b1: float, b2: float, eps: float, weight_decay: float):
    """One AdamW step. x, g: parameter dtype; mu, nu: f32; lr, c1, c2: f32
    tensors of one element (c = 1 - b**count). Returns new (x, mu, nu)."""
    f32 = torch.float32
    gf = g.float()
    mu_new = weak(b1, f32) * mu + weak(1 - b1, f32) * gf
    nu_new = weak(b2, f32) * nu + weak(1 - b2, f32) * (gf * gf)
    u = (mu_new / c1) / (torch.sqrt(nu_new / c2) + weak(eps, f32))
    if weight_decay:
        u = u + weak(weight_decay, f32) * x.float()
    x_new = (x.float() - lr * u).to(x.dtype)
    return x_new, mu_new, nu_new
