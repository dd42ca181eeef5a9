"""Mamba2 block (SSD) as used by Zamba2 [arXiv:2411.15242] (counterpart of
``repro.models.layers.mamba2``).

in_proj → [gate z | conv-stream (x, B, C) | dt] → causal conv1d → SSD scan
(K11 on the card) → gated RMSNorm (K7 at width d_inner) → out_proj.
Parameter names and shapes are the reference's, leaf for leaf, so
:func:`repro_torch.interop.params_from_numpy` carries its tree across.

The step size is ``softplus(dt + dt_bias)`` in f32 computed as the reference
does, ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``, with its gradient
``exp(x - out)`` (not ``F.softplus``, which switches to x above 20). The SSD
scan's D-skip term is rounded once with y, as the reference's CPU route
(``kernels/ssd_scan/ops.py``).

Modes as the reference's: ``"train"``; ``"prefill"`` (K11's forward, with
no gradient its no-grad route, returning the cache ``ssd_state`` (B,H,P,N)
f32 and ``conv_state``, the last ``conv_width - 1`` rows of the conv
stream before the conv, zero-padded on the left when the prompt is
shorter); and ``"decode"`` (one token: the conv over the window
``conv_state`` + the token, and the plain ``ssd_decode_step``, on either
device; the cache is written in place and returned). :func:`make_mamba_cache` makes an empty cache. The reference's
``constrain`` sharding hints are no-ops on one card and are dropped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm


def _dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    heads = d_inner // cfg.head_dim
    groups = 1
    return d_inner, heads, groups


def init_mamba2(b, name: str, d_model: int, cfg: SSMConfig):
    d_inner, heads, groups = _dims(d_model, cfg)
    n = cfg.state_dim
    conv_dim = d_inner + 2 * groups * n
    with b.scope(name):
        b.param("in_proj", (d_model, 2 * d_inner + 2 * groups * n + heads))
        b.param("conv_w", (cfg.conv_width, conv_dim))
        b.param("conv_b", (conv_dim,), init="zeros")
        b.param("a_log", (heads,), init="constant", scale=0.0)
        b.param("dt_bias", (heads,), init="zeros")
        b.param("d_skip", (heads,), init="ones")
        init_rmsnorm(b, "norm", d_inner)
        b.param("out_proj", (d_inner, d_model))


def _split(params, cfg: SSMConfig, d_model: int, xz):
    d_inner, heads, groups = _dims(d_model, cfg)
    n = cfg.state_dim
    z, xbc, dt = torch.split(xz, [d_inner, d_inner + 2 * groups * n, heads], dim=-1)
    return z, xbc, dt, d_inner, heads, groups, n


def _causal_conv(xbc, conv_w, conv_b, width: int):
    """xbc (B, S, C): the depthwise causal conv as width-shifted adds (width ≤ 4)."""
    out = xbc * conv_w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, : xbc.shape[1]]
        out = out + shifted * conv_w[-1 - i]
    return F.silu(out + conv_b)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` and its JVP, ``exp(x - out)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def mamba2_apply(
    params,
    cfg: SSMConfig,
    x,  # (B, S, d_model)
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Optional[dict]]:
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mamba2_apply: unknown mode {mode!r}")
    b_, s, d_model = x.shape
    if mode == "decode" and (cache is None or s != 1):
        raise ValueError(f"mamba2_apply(mode='decode') takes one token and a cache, got S={s}")
    xz = x @ params["in_proj"]
    z, xbc, dt, d_inner, heads, groups, n = _split(params, cfg, d_model, xz)
    A = -torch.exp(params["a_log"].to(torch.float32))
    new_cache = None
    if mode in ("train", "prefill"):
        xbc_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], cfg.conv_width)
        xs, B, C = torch.split(xbc_conv, [d_inner, groups * n, groups * n], dim=-1)
        xh = xs.reshape(b_, s, heads, cfg.head_dim)
        Bh = B.reshape(b_, s, groups, n)
        Ch = C.reshape(b_, s, groups, n)
        dt_s = softplus(dt.to(torch.float32) + params["dt_bias"])
        y, st = ssd_ops.ssd_scan(xh, dt_s, A, Bh, Ch, params["d_skip"], cfg.chunk_size)
        y = y.reshape(b_, s, d_inner)
        if mode == "prefill":
            w1 = cfg.conv_width - 1
            conv_state = F.pad(xbc, (0, 0, w1, 0))[:, xbc.shape[1]:]  # the last w1 rows, zeros before the prompt
            new_cache = dict(ssd_state=st, conv_state=conv_state.contiguous())
    else:  # one token against the cache
        window = torch.cat([cache["conv_state"], xbc], dim=1)  # (B, width, conv_dim)
        conv_out = torch.einsum("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"]
        xbc_conv = F.silu(conv_out)[:, None, :]
        xs, B, C = torch.split(xbc_conv, [d_inner, groups * n, groups * n], dim=-1)
        dt_s = softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])  # (B, H)
        y, st = ssd_ops.ssd_decode_step(cache["ssd_state"], xs[:, 0].reshape(b_, heads, cfg.head_dim), dt_s, A,
                                        B[:, 0].reshape(b_, groups, n), C[:, 0].reshape(b_, groups, n),
                                        params["d_skip"])
        y = y.reshape(b_, 1, d_inner)
        cache["ssd_state"].copy_(st)
        cache["conv_state"].copy_(window[:, 1:])
        new_cache = cache
    y = rmsnorm(params["norm"], y * F.silu(z), eps)
    return y @ params["out_proj"], new_cache


def make_mamba_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, device="cpu") -> dict:
    d_inner, heads, groups = _dims(d_model, cfg)
    n = cfg.state_dim
    conv_dim = d_inner + 2 * groups * n
    return dict(
        ssd_state=torch.zeros((batch, heads, cfg.head_dim, n), dtype=torch.float32, device=device),
        conv_state=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device),
    )
