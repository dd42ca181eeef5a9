"""RWKV-6 "Finch" block [arXiv:2404.05892] (counterpart of
``repro.models.layers.rwkv6``): time-mix with data-dependent decay (the WKV
recurrence, K12 on the card) + channel-mix.

Token-shift ddlerp (low-rank data-dependent interpolation between x_t and
x_{t-1}) feeds the r/k/v/w/g projections; the decay is
w_t = exp(-exp(w0 + lora_w(x_w))); a per-head WKV state with bonus u; a
grouped RMS-norm over each head (K7 on B·S·H rows of width head_dim);
squared-ReLU channel-mix. Parameter names and shapes are the reference's,
leaf for leaf, so :func:`repro_torch.interop.params_from_numpy` carries its
tree across.

The decay's type: ``w0 + dlora`` is added in the parameter type and cast to
f32 before the two exponentials, and w stays f32 on both devices: K12 takes
r/k/v/u in the parameter type and w in f32. This is the reference's CPU
route exactly (``wkv_chunked`` with an f32 w); its Pallas route casts w to
r's type, which in bf16 rounds every decay within 2^-9 of 1 to exactly 1
(values just below 1 are 2^-8 apart there).

Modes as the reference's: ``"train"``; ``"prefill"`` (K12's forward, with
no gradient its no-grad route, returning the cache ``wkv_state`` (B,H,N,N)
f32 and ``tm_last``, the last input row; the block adds ``cm_last``); and
``"decode"`` (one token: the shift from ``tm_last``/``cm_last`` and the
plain ``wkv_decode_step``, on either device; the cache is written in place
and returned). :func:`make_rwkv_cache` makes
an empty cache. The reference's ``constrain`` sharding hints are no-ops on
one card and are dropped.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm

_MIX = ("r", "k", "v", "w", "g")
_LORA_RANK = 32
_DECAY_RANK = 64


def init_rwkv6(b, name: str, d_model: int, cfg: SSMConfig):
    h, n = cfg.num_heads, cfg.head_dim
    d_attn = h * n
    with b.scope(name):
        # time-mix
        b.param("mu_x", (d_model,), init="constant", scale=0.5)
        b.param("mix_w1", (d_model, len(_MIX) * _LORA_RANK))
        b.param("mix_w2", (len(_MIX), _LORA_RANK, d_model))
        b.param("mu", (len(_MIX), d_model), init="constant", scale=0.5)
        b.param("wr", (d_model, h * n))
        b.param("wk", (d_model, h * n))
        b.param("wv", (d_model, h * n))
        b.param("wg", (d_model, d_attn))
        b.param("w0", (h, n), init="constant", scale=-2.0)
        b.param("decay_w1", (d_model, _DECAY_RANK))
        b.param("decay_w2", (_DECAY_RANK, h * n))
        b.param("u_bonus", (h, n), init="normal", scale=0.3)
        init_rmsnorm(b, "gnorm", n)
        b.param("wo", (d_attn, d_model))
        # channel-mix
        b.param("cmix_mu_k", (d_model,), init="constant", scale=0.5)
        b.param("cmix_mu_r", (d_model,), init="constant", scale=0.5)


def init_rwkv6_ffn(b, name: str, d_model: int, d_ff: int):
    with b.scope(name):
        b.param("wk", (d_model, d_ff))
        b.param("wv", (d_ff, d_model))
        b.param("wr", (d_model, d_model))


def _shift(x, last):
    """x_{t-1} stream: shift right by one; position 0 takes ``last``."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv6_timemix_apply(
    params,
    cfg: SSMConfig,
    x,
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Optional[dict]]:
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"rwkv6_timemix_apply: unknown mode {mode!r}")
    b_, s, d = x.shape
    if mode == "decode" and (cache is None or s != 1):
        raise ValueError(f"rwkv6_timemix_apply(mode='decode') takes one token and a cache, got S={s}")
    h, n = cfg.num_heads, cfg.head_dim
    last = cache["tm_last"][:, None, :] if cache is not None else None
    prev = _shift(x, last)
    dx = prev - x

    # ddlerp: x_s = x + dx * (mu_s + lora_s(x + dx * mu_x))
    base = x + dx * params["mu_x"]
    lora = torch.tanh(base @ params["mix_w1"]).reshape(b_, s, len(_MIX), _LORA_RANK)
    lora = torch.einsum("bsmr,mrd->bsmd", lora, params["mix_w2"])
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (params["mu"] + lora)  # (B, S, 5, d)
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(len(_MIX)))

    r = (xr @ params["wr"]).reshape(b_, s, h, n)
    k = (xk @ params["wk"]).reshape(b_, s, h, n)
    v = (xv @ params["wv"]).reshape(b_, s, h, n)
    g = F.silu(xg @ params["wg"])

    dlora = (torch.tanh(xw @ params["decay_w1"]) @ params["decay_w2"]).reshape(b_, s, h, n)
    w = torch.exp(-torch.exp((params["w0"] + dlora).to(torch.float32)))  # (B, S, H, N) in (0, 1), f32

    new_cache = None
    if mode in ("train", "prefill"):
        y, st = wkv_ops.wkv(r, k, v, w, params["u_bonus"], cfg.chunk_size)
        if mode == "prefill":
            new_cache = dict(wkv_state=st, tm_last=x[:, -1])
    else:
        y, st = wkv_ops.wkv_decode_step(cache["wkv_state"], r[:, 0], k[:, 0], v[:, 0], w[:, 0], params["u_bonus"])
        y = y[:, None]
        cache["wkv_state"].copy_(st)
        cache["tm_last"].copy_(x[:, 0])
        new_cache = cache
    y = rmsnorm(params["gnorm"], y, eps).reshape(b_, s, h * n) * g
    return y @ params["wo"], new_cache


def rwkv6_channelmix_apply(
    params_tm,
    params_ffn,
    x,
    *,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    last = cache["cm_last"][:, None, :] if cache is not None else None
    prev = _shift(x, last)
    dx = prev - x
    xk = x + dx * params_tm["cmix_mu_k"]
    xr = x + dx * params_tm["cmix_mu_r"]
    kk = torch.square(torch.relu(xk @ params_ffn["wk"]))
    out = torch.sigmoid(xr @ params_ffn["wr"]) * (kk @ params_ffn["wv"])
    if cache is not None:
        cache["cm_last"].copy_(x[:, -1])
    return out, cache


def make_rwkv_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, device="cpu") -> dict:
    h, n = cfg.num_heads, cfg.head_dim
    return dict(
        wkv_state=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
        tm_last=torch.zeros((batch, d_model), dtype=dtype, device=device),
        cm_last=torch.zeros((batch, d_model), dtype=dtype, device=device),
    )
