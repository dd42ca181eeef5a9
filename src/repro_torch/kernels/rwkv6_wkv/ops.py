"""RWKV-6 WKV wrapper: the CUDA kernels of ``csrc/rwkv6_wkv.cu`` for CUDA
tensors, the plain ``ref.wkv_chunked`` for CPU tensors (counterpart of
``repro.kernels.rwkv6_wkv.ops``), and an autograd Function whose backward is
the backward kernels.

Each direction is two launches, each counted on a ``Kernel`` of its own. The
forward's first (``wkv_fwd_local``) computes every chunk's local state and,
in the CTA that finishes a (batch, head) row last, runs the state's
recurrence over the row's chunks: the state entering each chunk (kept for
the backward when a gradient is wanted, else left in a workspace planned
once a chunk count) and the final state. Its second (``wkv_fwd``, K12) writes y, a
chunk a CTA. The backward's first (``wkv_bwd_local``) does the same for the
cotangent of the state, backward from the final state's; its second
(``wkv_bwd``) the gradients, a chunk a CTA, du as a partial a (row, chunk)
that is summed here in a fixed order (chunks, then the batch; no float
atomics). Unlike the reference's wrapper nothing is padded or transposed:
the kernels read the (B, S, H, N) layout directly and bounds-check the last
chunk.

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

FWD_LOCAL = Kernel("wkv_fwd_local", {"wkv_fwd_local_launch": [P] * 7 + [I] * 6 + [P]}, source="rwkv6_wkv")
FWD = Kernel("wkv_fwd", {"wkv_fwd_launch": [P] * 7 + [I] * 6 + [P]}, source="rwkv6_wkv")
BWD_LOCAL = Kernel("wkv_bwd_local", {"wkv_bwd_local_launch": [P] * 7 + [I] * 6 + [P]}, source="rwkv6_wkv")
BWD = Kernel("wkv_bwd", {"wkv_bwd_launch": [P] * 13 + [I] * 6 + [P]}, source="rwkv6_wkv")
HEAD_DIMS = (32, 64)
CHUNKS = (16, 32, 64)

_WORK: dict = {}  # device index -> (f32 workspace, int32 ticket counters), grown when needed
_PLANS: dict = {}  # (device index, B·H, chunks, N, states kept) -> views of the workspace


def _plan(device, b: int, s: int, h: int, n: int, chunk: int, keep: bool):
    """(tbuf, the chunk states or None, counters) of one shape: each chunk's
    total (B·H, nc, N) and, unless the caller keeps the states, the states'
    (B·H, nc, N, N) f32, as views of a per-device workspace; the ticket
    counters (one a row, left zero by every launch). Planned once per
    (rows, chunk count, N): the views depend on nothing else, so serving's
    many prompt lengths share a plan per chunk count. When the workspace
    grows, the device's plans are dropped with the old workspace, so no
    plan keeps a stale buffer alive and the workspace is the largest shape
    seen, once."""
    rows, nc = b * h, -(-s // chunk)
    key = (device.index, rows, nc, n, keep)
    plan = _PLANS.get(key)
    if plan is None:
        size = rows * nc * n * (1 if keep else n + 1)
        ws, cnt = _WORK.get(device.index, (None, None))
        if ws is None or ws.numel() < size or cnt.numel() < rows:
            for stale in [k for k in _PLANS if k[0] == device.index]:
                del _PLANS[stale]
            ws = torch.empty(max(size, 0 if ws is None else ws.numel()), dtype=torch.float32, device=device)
            cnt = torch.zeros(max(rows, 0 if cnt is None else cnt.numel()), dtype=torch.int32, device=device)
            _WORK[device.index] = (ws, cnt)
        tbuf = ws[: rows * nc * n]
        states = None if keep else ws[rows * nc * n: size].view(rows, nc, n, n)
        plan = _PLANS[key] = (tbuf, states, cnt)
    return plan


def _ready(*tensors):
    """Each tensor contiguous and 16-byte aligned (the kernels read rows in
    16-byte vectors): a view that starts off the grain is copied."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


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


def wkv_states_bh(k, v, w, *, chunk: int = 32, keep: bool = True):
    """(the state entering each chunk (B·H, nc, N, P) f32, the final state
    (B,H,N,P) f32): the forward's first launch (``wkv_fwd_local``); CPU
    tensors: the plain ``ref.wkv_states``. With ``keep`` False the chunk
    states are the planned workspace's, valid until the next call on this
    device."""
    if all(t.device.type == "cpu" for t in (k, v, w)):
        return _ref.wkv_states(k, v, w, chunk)
    _on_card("wkv_states_bh", (k, v, w), k, v, w, chunk)
    k, v, w = _ready(k, v, w)
    b, s, h, n = k.shape
    tbuf, states, cnt = _plan(k.device, b, s, h, n, chunk, keep)
    if states is None:
        states = torch.empty((b * h, -(-s // chunk), n, n), dtype=torch.float32, device=k.device)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=k.device)
    FWD_LOCAL.launch("wkv_fwd_local_launch", k.data_ptr(), v.data_ptr(), w.data_ptr(), states.data_ptr(),
                     tbuf.data_ptr(), state.data_ptr(), cnt.data_ptr(), b, s, h, n, chunk, dtype_code(k.dtype),
                     stream_ptr(k.device))
    return states, state


def wkv_bh(r, k, v, w, u, *, chunk: int = 32, save_states: bool = False):
    """(y (B,S,H,P) in r's type, final state (B,H,N,P) f32, the chunks'
    starting states (B·H, nc, N, P) f32 when ``save_states``, else None) on
    the card: ``wkv_fwd_local``, then ``wkv_fwd``. Replaces
    ``rwkv6_wkv/kernel.py::wkv_bh``."""
    _check(r, k, v, w, u, chunk)
    _on_card("wkv_bh", (r, k, v, w, u), r, v, w, chunk)
    if not (r.dtype == k.dtype == v.dtype == u.dtype):
        raise TypeError(f"wkv_bh: r, k, v, u dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    r, k, v, w, u = _ready(r, k, v, w, u)
    states, state = wkv_states_bh(k, v, w, chunk=chunk, keep=save_states)
    return wkv_y_bh(r, k, v, w, u, states, chunk=chunk), state, (states if save_states else None)


def wkv_y_bh(r, k, v, w, u, states, *, chunk: int = 32):
    """y (B,S,H,P) in r's type from the state entering each chunk: the
    forward's second launch (``wkv_fwd``) on card tensors already checked
    and made ready (contiguous, 16-byte aligned) by :func:`wkv_bh`."""
    b, s, h, n = r.shape
    y = torch.empty_like(v)
    FWD.launch("wkv_fwd_launch", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
               states.data_ptr(), b, s, h, n, chunk, dtype_code(r.dtype), stream_ptr(r.device))
    return y


def wkv_dstates_bh(r, w, dy, dstate: Optional[torch.Tensor], *, chunk: int = 32, keep: bool = True):
    """The cotangent of the state leaving each chunk (B·H, nc, N, P) f32,
    from dy (B,S,H,P) in r's type and the final state's cotangent (None for
    zero): the backward's first launch (``wkv_bwd_local``); CPU tensors: the
    plain ``ref.wkv_dstates``. With ``keep`` False it is the planned
    workspace's, valid until the next call."""
    if all(t.device.type == "cpu" for t in (r, w, dy) + (() if dstate is None else (dstate,))):
        return _ref.wkv_dstates(r, w, dy, dstate, chunk)
    _on_card("wkv_dstates_bh", (r, w, dy) + (() if dstate is None else (dstate,)), r, dy, w, chunk)
    b, s, h, n = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError(f"wkv_dstates_bh: dy must be {tuple(r.shape)} {r.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if dstate is not None and dstate.shape != (b, h, n, n):
        raise ValueError(f"wkv_dstates_bh: dstate must be {(b, h, n, n)}, got {tuple(dstate.shape)}")
    r, w, dy = _ready(r, w, dy)
    dstate = None if dstate is None else dstate.to(torch.float32).contiguous()
    tbuf, dws, cnt = _plan(r.device, b, s, h, n, chunk, keep)
    if dws is None:
        dws = torch.empty((b * h, -(-s // chunk), n, n), dtype=torch.float32, device=r.device)
    BWD_LOCAL.launch("wkv_bwd_local_launch", r.data_ptr(), w.data_ptr(), dy.data_ptr(),
                     0 if dstate is None else dstate.data_ptr(), dws.data_ptr(), tbuf.data_ptr(), cnt.data_ptr(),
                     b, s, h, n, chunk, dtype_code(r.dtype), stream_ptr(r.device))
    return dws


def wkv_bwd_bh(r, k, v, w, u, dy, states, dstate: Optional[torch.Tensor], *, chunk: int = 32):
    """(dr, dk, dv, dw, du) from the forward's chunk states and the
    cotangents of y and of the final state (``dstate`` None for zero):
    ``wkv_bwd_local``, then ``wkv_bwd`` (new for the port)."""
    _check(r, k, v, w, u, chunk)
    tensors = (r, k, v, w, u, dy, states) + (() if dstate is None else (dstate,))
    _on_card("wkv_bwd_bh", tensors, r, v, w, chunk)
    b, s, h, n = r.shape
    nc = -(-s // chunk)
    if dy.shape != v.shape or dy.dtype != r.dtype:
        raise ValueError(f"wkv_bwd_bh: dy must match y: {tuple(v.shape)} {r.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if states.shape != (b * h, nc, n, n) or (dstate is not None and dstate.shape != (b, h, n, n)):
        raise ValueError("wkv_bwd_bh: chunk states or dstate of the wrong shape")
    r, k, v, w, u, dy, states = _ready(r, k, v, w, u, dy, states)
    dws = wkv_dstates_bh(r, w, dy, dstate, chunk=chunk, keep=False)
    return wkv_grads_bh(r, k, v, w, u, dy, states, dws, chunk=chunk)


def wkv_grads_bh(r, k, v, w, u, dy, states, dws, *, chunk: int = 32):
    """(dr, dk, dv, dw, du) from the states entering and the cotangents
    leaving each chunk: the backward's second launch (``wkv_bwd``) on card
    tensors already checked and made ready by :func:`wkv_bwd_bh`; du sums
    its per-(row, chunk) partials over the chunks, then over the batch."""
    b, s, h, n = r.shape
    nc = -(-s // chunk)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w)
    du_part = torch.empty((b, h, nc, n), dtype=torch.float32, device=r.device)
    BWD.launch("wkv_bwd_launch", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), dy.data_ptr(),
               states.data_ptr(), dws.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
               du_part.data_ptr(), b, s, h, n, chunk, dtype_code(r.dtype), stream_ptr(r.device))
    return dr, dk, dv, dw, du_part.sum(2).sum(0).to(u.dtype)


class WKV(torch.autograd.Function):
    """Forward kernels (saving the chunks' starting states); backward kernels."""

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
    through it is the plain backward). CUDA tensors: K12's forward kernels
    and, when a gradient is wanted, its backward kernels."""
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
    the reference's ``ops.wkv_decode_step`` (serving's dense decode,
    ``models/layers/rwkv6.py``)."""
    f32 = torch.float32
    rf, kf, vf, wf = (t.to(f32) for t in (r_t, k_t, v_t, w_t))
    kv = torch.einsum("bhn,bhp->bhnp", kf, vf)
    y = torch.einsum("bhn,bhnp->bhp", rf, u.to(f32)[None, :, :, None] * kv + state)
    state = wf[..., None] * state + kv
    return y.to(r_t.dtype), state
