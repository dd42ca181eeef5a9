"""RWKV-6 WKV wrapper: the CUDA kernels of ``csrc/rwkv6_wkv.cu`` for CUDA
tensors, the plain ``ref.wkv_chunked`` for CPU tensors (counterpart of
``repro.kernels.rwkv6_wkv.ops``), and an autograd Function whose backward is
the backward kernel.

The forward kernel (K12) writes each chunk's starting state when a gradient
is wanted; the backward kernel walks the chunks in reverse from them and
takes the cotangents of y and of the final state. Each wrapper counts its
own launches. Unlike the reference's wrapper nothing is padded or
transposed: the kernels read the (B, S, H, N) layout directly and
bounds-check the last chunk.

Types: r, k, v, u in one type (float32 or bfloat16), w in float32 (the port
keeps the decay in f32 on both devices; see ``models/layers/rwkv6.py``); y in
r's type, the final state in f32; the gradients in their inputs' types.

Kernel vs plain, stated bounds (checked on the card by ``chip_smoke.py``),
as max|kernel − plain| / max|plain|: f32 2e-5 for y and the final state,
1e-4 for each gradient (both sum in f32 in other orders; the plain backward
is torch autograd of ``wkv_chunked``); bf16 inputs 2^-7 for y, 2e-5 for the
f32 state and 2^-5 for each gradient (one rounding of each output to bf16,
where a value near a rounding boundary may round either way).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.rwkv6_wkv import ref as _ref

FWD = Kernel("wkv_fwd", {"wkv_fwd_launch": [P] * 8 + [I] * 6 + [P]}, source="rwkv6_wkv")
BWD = Kernel("wkv_bwd", {"wkv_bwd_launch": [P] * 13 + [I] * 6 + [P]}, source="rwkv6_wkv")
HEAD_DIMS = (32, 64)
CHUNKS = (16, 32, 64)


def _check(r, k, v, w, u, chunk):
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"wkv takes r, k, w (B,S,H,N) and v (B,S,H,P), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    if u.shape != (r.shape[2], r.shape[3]):
        raise ValueError(f"wkv: u must be (H, N) = {(r.shape[2], r.shape[3])}, got {tuple(u.shape)}")
    if chunk < 1:
        raise ValueError(f"wkv: chunk must be >= 1, got {chunk}")


def _on_card(name, tensors, r, v, w, chunk):
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    n = r.shape[3]
    if n not in HEAD_DIMS or v.shape[3] != n or chunk not in CHUNKS:
        raise ValueError(f"{name}: the CUDA kernel takes N = P in {HEAD_DIMS} and chunk in {CHUNKS}, got "
                         f"N={n}, P={v.shape[3]}, chunk={chunk}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w must be float32, got {w.dtype}")


def wkv_bh(r, k, v, w, u, *, chunk: int = 32, save_states: bool = False):
    """(y (B,S,H,P) in r's type, final state (B,H,N,P) f32, the chunks'
    starting states (B·H, nc, N, P) f32 when ``save_states``, else None) on
    the card. Replaces ``rwkv6_wkv/kernel.py::wkv_bh``."""
    _check(r, k, v, w, u, chunk)
    _on_card("wkv_bh", (r, k, v, w, u), r, v, w, chunk)
    if not (r.dtype == k.dtype == v.dtype == u.dtype):
        raise TypeError(f"wkv_bh: r, k, v, u dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    b, s, h, n = r.shape
    nc = -(-s // chunk)
    y = torch.empty_like(v)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    states = torch.empty((b * h, nc, n, n), dtype=torch.float32, device=r.device) if save_states else None
    FWD.launch("wkv_fwd_launch", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
               state.data_ptr(), 0 if states is None else states.data_ptr(), b, s, h, n, chunk, dtype_code(r.dtype),
               stream_ptr(r.device))
    return y, state, states


def wkv_bwd_bh(r, k, v, w, u, dy, states, dstate: Optional[torch.Tensor], *, chunk: int = 32):
    """(dr, dk, dv, dw, du) from the forward's chunk states and the
    cotangents of y and of the final state (``dstate`` None for zero); the
    backward kernel (new for the port). du sums the per-row partials over
    the batch in order."""
    _check(r, k, v, w, u, chunk)
    tensors = (r, k, v, w, u, dy, states) + (() if dstate is None else (dstate,))
    _on_card("wkv_bwd_bh", tensors, r, v, w, chunk)
    b, s, h, n = r.shape
    if dy.shape != v.shape or dy.dtype != r.dtype:
        raise ValueError(f"wkv_bwd_bh: dy must match y: {tuple(v.shape)} {r.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if states.shape != (b * h, -(-s // chunk), n, n) or (dstate is not None and dstate.shape != (b, h, n, n)):
        raise ValueError("wkv_bwd_bh: chunk states or dstate of the wrong shape")
    r, k, v, w, u, dy, states = (t.contiguous() for t in (r, k, v, w, u, dy, states))
    dstate = None if dstate is None else dstate.to(torch.float32).contiguous()
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du_part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    BWD.launch("wkv_bwd_launch", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), dy.data_ptr(),
               states.data_ptr(), 0 if dstate is None else dstate.data_ptr(), dr.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), b, s, h, n, chunk, dtype_code(r.dtype),
               stream_ptr(r.device))
    du = du_part[0]
    for i in range(1, b):
        du = du + du_part[i]
    return dr, dk, dv, dw, du.to(u.dtype)


class WKV(torch.autograd.Function):
    """Forward kernel (saving the chunks' starting states); backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        y, state, states = wkv_bh(r, k, v, w, u, chunk=chunk, save_states=True)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(v)
        grads = wkv_bwd_bh(r, k, v, w, u, dy.to(r.dtype), states, dstate, chunk=ctx.chunk)
        return (*grads, None)


def wkv(r, k, v, w, u, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w (B,S,H,N); v (B,S,H,P); u (H,N) -> (y (B,S,H,P), state
    (B,H,N,P) f32). CPU tensors: the plain ``wkv_chunked`` (torch autograd
    through it is the plain backward). CUDA tensors: K12 and, when a
    gradient is wanted, the backward kernel."""
    _check(r, k, v, w, u, chunk)
    if all(t.device.type == "cpu" for t in (r, k, v, w, u)):
        return _ref.wkv_chunked(r, k, v, w, u, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        return WKV.apply(r, k, v, w, u, chunk)
    y, state, _ = wkv_bh(r, k, v, w, u, chunk=chunk)
    return y, state


def wkv_decode_step(state, r_t, k_t, v_t, w_t, u):
    """Single-token recurrence: state (B,H,N,P) f32; r/k/w (B,H,N); v (B,H,P)
    -> (y (B,H,P) in r's type, new state). Plain torch on either device, as
    the reference's ``ops.wkv_decode_step``; the dense decode path that calls
    it is ROADMAP Queue 1 item 7."""
    f32 = torch.float32
    rf, kf, vf, wf = (t.to(f32) for t in (r_t, k_t, v_t, w_t))
    kv = torch.einsum("bhn,bhp->bhnp", kf, vf)
    y = torch.einsum("bhn,bhnp->bhp", rf, u.to(f32)[None, :, :, None] * kv + state)
    state = wf[..., None] * state + kv
    return y.to(r_t.dtype), state
