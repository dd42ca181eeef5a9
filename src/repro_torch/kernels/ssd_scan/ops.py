"""Mamba2 SSD scan wrapper: the CUDA kernels of ``csrc/ssd_scan.cu`` for CUDA
tensors, the plain ``ref.ssd_chunked`` for CPU tensors (counterpart of
``repro.kernels.ssd_scan.ops``), and an autograd Function whose backward is
the backward kernels.

Each direction is two launches, each counted on a ``Kernel`` of its own. The
forward's first (``ssd_fwd_local``) computes every chunk's local state and,
in the CTA that finishes a (batch, head) row last, runs the state's
recurrence over the row's chunks: the state entering each chunk (kept for
the backward when a gradient is wanted) and the final state. Its second
(``ssd_fwd``, K11) writes y before the D-skip term, in f32, a chunk a CTA.
The backward's first (``ssd_bwd_local``) does the same for the cotangent of
the state, backward from the final state's; its second (``ssd_bwd``) the
gradients, a CTA per (batch, chunk, block of heads of one group). The D-skip
term is torch here: ``y + x·D`` in f32, then one rounding to x's type. That
is the rounding of the reference's ``ssd_chunked`` (``ref.py:120-121``), the
reference model's CPU route, which the port follows on both devices; the
reference's Pallas route rounds y to x's type before it adds ``x·D`` in that
type (ROADMAP Queue 3, "Known differences"). Unlike the reference's wrapper
nothing is padded, transposed or repeated: the kernels read the (B, S, H, ·)
layout directly, read B and C by group (head h reads group h // (H/G)) and
bounds-check the last chunk, so S need not be a whole number of chunks and
S < chunk is one ragged chunk (the reference's Pallas route would shrink the
chunk to S instead).

Types: x, B, C in one type (float32 or bfloat16), dt and A in float32; y
before the D-skip and the states in f32; the gradients in their inputs'
types. dB and dC sum a group's heads: a CTA sums its block of heads
(:func:`heads_per_cta`), and the blocks' partials are summed here in a fixed
order, as are dA's per-chunk partials (no float atomics).

Kernel vs plain, stated bounds (checked on the card by ``chip_smoke.py``
and ``tests/test_torch_kernels.py``), as max|kernel − plain| / max|plain|,
the plain backward being torch autograd of ``ssd_chunked``: with either
input type, 2e-5 for y before the D-skip and for the final state (both f32,
summed in other orders, the tensor cores' products of bf16 high and low
parts); f32 inputs 1e-4 for each gradient; bf16 x/B/C 2^-7 for dx, dB and dC
(one rounding of each, where a value near a rounding boundary may round
either way) and 1e-4 for ddt and dA (f32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import I, Kernel, P, dtype_code, stream_ptr
from repro_torch.kernels.ssd_scan import ref as _ref

FWD_LOCAL = Kernel("ssd_fwd_local", {"ssd_fwd_local_launch": [P] * 8 + [I] * 8 + [P]}, source="ssd_scan")
FWD = Kernel("ssd_fwd", {"ssd_fwd_launch": [P] * 7 + [I] * 8 + [P]}, source="ssd_scan")
BWD_LOCAL = Kernel("ssd_bwd_local", {"ssd_bwd_local_launch": [P] * 8 + [I] * 8 + [P]}, source="ssd_scan")
BWD = Kernel("ssd_bwd", {"ssd_bwd_launch": [P] * 13 + [I] * 9 + [P]}, source="ssd_scan")
MAX_DIM = 64  # head_dim P and state N: a tile row is 64 bf16 values
MAX_CHUNK = 128  # a warp a 16 rows of the chunk, eight warps
WAVE = 128  # the backward's main grid aims at about one wave of the H100's 132 SMs


def heads_per_cta(b: int, nc: int, h: int, g: int) -> int:
    """Heads a CTA of the backward's main kernel takes (consecutive heads of
    one group; it sums their dB and dC): the largest power of two dividing
    the heads of a group that keeps at least :data:`WAVE` CTAs (4 at
    zamba2's slice: B 2 x 4 chunks x 16 blocks of 4 of the 64 heads)."""
    k = 1
    while (h // g) % (2 * k) == 0 and b * nc * (h // (2 * k)) >= WAVE:
        k *= 2
    return k


_COUNTERS: dict = {}  # device index -> int32 ticket counters, zero, grown when needed


def _counters(device, n: int) -> torch.Tensor:
    """The local kernels' ticket counters (one a (batch, head) row; every
    launch leaves them zero), held per device across calls."""
    cnt = _COUNTERS.get(device.index)
    if cnt is None or cnt.numel() < n:
        cnt = _COUNTERS[device.index] = torch.zeros(n, dtype=torch.int32, device=device)
    return cnt


def _check(x, dt, A, B, C, chunk):
    if x.dim() != 4 or dt.shape != x.shape[:3] or A.shape != (x.shape[2],):
        raise ValueError(f"ssd_scan takes x (B,S,H,P), dt (B,S,H) and A (H,), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if B.dim() != 4 or C.shape != B.shape or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd_scan takes B, C (B,S,G,N), got {tuple(B.shape)}, {tuple(C.shape)}")
    if x.shape[2] % B.shape[2]:
        raise ValueError(f"ssd_scan: the groups G={B.shape[2]} must divide the heads H={x.shape[2]}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")


def _on_card(name, tensors, x, B, dt, A, chunk):
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    p, n = x.shape[3], B.shape[3]
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM and chunk <= MAX_CHUNK):
        raise ValueError(f"{name}: the CUDA kernel takes P and N up to {MAX_DIM} and chunk up to {MAX_CHUNK}, got "
                         f"P={p}, N={n}, chunk={chunk}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got {dt.dtype}, {A.dtype}")


def _dims(x, B):
    b, s, h, p = x.shape
    return b, s, h, B.shape[2], p, B.shape[3]


def ssd_states_bh(x, dt, A, B, *, chunk: int = 64):
    """(the state entering each chunk (B·H, nc, P, N) f32, the final state
    (B,H,P,N) f32): the forward's first launch (``ssd_fwd_local``) on
    contiguous card tensors already checked by :func:`ssd_scan_bh`."""
    b, s, h, g, p, n = _dims(x, B)
    nc, rows = -(-s // chunk), b * h
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(rows * nc * (p * n + 1), dtype=torch.float32, device=x.device)
    states, tbuf = scratch[: rows * nc * p * n].view(rows, nc, p, n), scratch[rows * nc * p * n:]
    FWD_LOCAL.launch("ssd_fwd_local_launch", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     states.data_ptr(), tbuf.data_ptr(), state.data_ptr(), _counters(x.device, rows).data_ptr(),
                     b, s, h, g, p, n, chunk, dtype_code(x.dtype), stream_ptr(x.device))
    return states, state


def ssd_scan_bh(x, dt, A, B, C, *, chunk: int = 64, save_states: bool = False):
    """(y (B,S,H,P) f32 before the D-skip, final state (B,H,P,N) f32, the
    chunks' starting states (B·H, nc, P, N) f32 when ``save_states``, else
    None) on the card. Replaces ``ssd_scan/kernel.py::ssd_scan_bh``."""
    _check(x, dt, A, B, C, chunk)
    _on_card("ssd_scan_bh", (x, dt, A, B, C), x, B, dt, A, chunk)
    if not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"ssd_scan_bh: x, B, C dtypes differ: {x.dtype}, {B.dtype}, {C.dtype}")
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    states, state = ssd_states_bh(x, dt, A, B, chunk=chunk)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    FWD.launch("ssd_fwd_launch", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
               states.data_ptr(), *_dims(x, B), chunk, dtype_code(x.dtype), stream_ptr(x.device))
    return y, state, (states if save_states else None)


def ssd_dstates_bh(dt, A, C, dy, dstate, *, chunk: int = 64):
    """The cotangent of the state leaving each chunk (B·H, nc, P, N) f32,
    from dy (B,S,H,P) f32 and the final state's cotangent (None for zero):
    the backward's first launch (``ssd_bwd_local``) on contiguous card
    tensors already checked by :func:`ssd_scan_bwd_bh`."""
    b, s, h, p = dy.shape
    g, n = C.shape[2], C.shape[3]
    nc, rows = -(-s // chunk), b * h
    scratch = torch.empty(rows * nc * (p * n + 1), dtype=torch.float32, device=dy.device)
    dws, tbuf = scratch[: rows * nc * p * n].view(rows, nc, p, n), scratch[rows * nc * p * n:]
    BWD_LOCAL.launch("ssd_bwd_local_launch", dt.data_ptr(), A.data_ptr(), C.data_ptr(), dy.data_ptr(),
                     0 if dstate is None else dstate.data_ptr(), dws.data_ptr(), tbuf.data_ptr(),
                     _counters(dy.device, rows).data_ptr(), b, s, h, g, p, n, chunk, dtype_code(C.dtype),
                     stream_ptr(dy.device))
    return dws


def ssd_scan_bwd_bh(x, dt, A, B, C, dy, states, dstate: Optional[torch.Tensor], *, chunk: int = 64):
    """(dx, ddt, dA, dB, dC) from the forward's chunk states and the
    cotangents of y (f32, before the D-skip) and of the final state
    (``dstate`` None for zero); the backward kernels (new for the port). The
    main kernel writes each chunk's share of dA and each block of heads'
    share of dB and dC; they are summed here, over the chunks and batch rows
    and over the blocks of each group, in a fixed order."""
    _check(x, dt, A, B, C, chunk)
    tensors = (x, dt, A, B, C, dy, states) + (() if dstate is None else (dstate,))
    _on_card("ssd_scan_bwd_bh", tensors, x, B, dt, A, chunk)
    b, s, h, g, p, n = _dims(x, B)
    nc = -(-s // chunk)
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd_bh: dy must be f32 {tuple(x.shape)}, got {tuple(dy.shape)} {dy.dtype}")
    if states.shape != (b * h, nc, p, n) or (dstate is not None and dstate.shape != (b, h, p, n)):
        raise ValueError("ssd_scan_bwd_bh: chunk states or dstate of the wrong shape")
    x, dt, A, B, C, dy, states = (t.contiguous() for t in (x, dt, A, B, C, dy, states))
    dstate = None if dstate is None else dstate.to(torch.float32).contiguous()
    dws = ssd_dstates_bh(dt, A, C, dy, dstate, chunk=chunk)
    hpc = heads_per_cta(b, nc, h, g)
    blocks = h // hpc
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    sizes = (b * s * blocks * n, b * s * blocks * n, b * nc * h)
    db_part, dc_part, da_part = torch.empty(sum(sizes), dtype=torch.float32, device=x.device).split(sizes)
    BWD.launch("ssd_bwd_launch", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
               states.data_ptr(), dws.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da_part.data_ptr(),
               db_part.data_ptr(), dc_part.data_ptr(), b, s, h, g, p, n, chunk, hpc, dtype_code(x.dtype),
               stream_ptr(x.device))
    dA = da_part.view(b * nc, h).sum(0)
    dB = db_part.view(b, s, g, blocks // g, n).sum(3).to(B.dtype)
    dC = dc_part.view(b, s, g, blocks // g, n).sum(3).to(C.dtype)
    return dx, ddt, dA.to(A.dtype), dB, dC


class SSDScan(torch.autograd.Function):
    """Forward kernels (saving the chunks' starting states); backward kernels.
    Returns y before the D-skip, in f32, and the final state."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        y, state, states = ssd_scan_bh(x, dt, A, B, C, chunk=chunk, save_states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd_bh(x, dt, A, B, C, dy.to(torch.float32), states, dstate, chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, D, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N); D (H,) -> (y (B,S,H,P)
    in x's type, final state (B,H,P,N) f32). CPU tensors: the plain
    ``ssd_chunked`` (torch autograd through it is the plain backward). CUDA
    tensors: K11 and, when a gradient is wanted, the backward kernel; the
    D-skip term in torch, rounded once with y."""
    _check(x, dt, A, B, C, chunk)
    if D.shape != (x.shape[2],):
        raise ValueError(f"ssd_scan: D must be (H,) = ({x.shape[2]},), got {tuple(D.shape)}")
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C, D)):
        return _ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        y, state = SSDScan.apply(x, dt, A, B, C, chunk)
    else:
        y, state, _ = ssd_scan_bh(x, dt, A, B, C, chunk=chunk)
    y = y + x.to(torch.float32) * D[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D):
    """Single-token recurrent update: state (B,H,P,N) f32; x_t (B,H,P); dt_t
    (B,H); B_t/C_t (B,G,N) -> (y (B,H,P) in x_t's type, new state). Plain
    torch on either device, as the reference's ``ops.ssd_decode_step``
    (serving's dense decode, ``models/layers/mamba2.py``)."""
    f32 = torch.float32
    h, g = x_t.shape[1], B_t.shape[1]
    Bh = torch.repeat_interleave(B_t, h // g, dim=1).to(f32)
    Ch = torch.repeat_interleave(C_t, h // g, dim=1).to(f32)
    dtf = dt_t.to(f32)
    decay = torch.exp(dtf * A)[..., None, None]
    upd = torch.einsum("bhp,bhn->bhpn", x_t.to(f32) * dtf[..., None], Bh)
    state = decay * state + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + x_t.to(f32) * D[None, :, None]
    return y.to(x_t.dtype), state
