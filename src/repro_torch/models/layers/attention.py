"""Grouped-query attention and DeepSeek-V3's multi-head latent attention
(counterpart of ``repro.models.layers.attention``).

Ported: ``init_gqa``, ``init_qk_norm``, ``_project_qkv`` (with
``qkv_bias``), the optional QK-norm (an RMSNorm of each head's q and k over
head_dim before RoPE, through kernel K7 on the card, forward and backward),
the pre-scaling ``q / sqrt(head_dim)`` in the activation dtype, and every
mode of ``gqa_apply``:

* ``mode="train"``: causal (optionally windowed) attention over the whole
  sequence through ``_sdpa``, which is kernel K6 (``flash_attention``,
  forward and backward kernels) for CUDA tensors and its plain version for
  CPU tensors;
* ``mode="prefill"``: the same attention (K6's forward alone when no
  gradient is wanted), and the dense cache made from the prompt's K and V
  (``_init_cache_from_prefill``: the last ``window`` positions under a
  sliding window);
* ``mode="decode"`` with ``paged=``: append K and V (kernel K10, both pools
  in one launch, in place), then attend (kernel K9 for one token per slot;
  the plain chunked-prefill body for T > 1);
* dense ``mode="decode"``: write the token's K and V into its ring slot,
  then ``_decode_attend``, plain torch on either device as in the
  reference (f32 scores, masked by each slot's absolute position).

The dense cache is ``k``/``v`` (B, L, Hkv, D), ``positions`` (L,) int32 (the
absolute position each slot holds, -1 when empty) and ``pos`` (0-dim
int32, the next position); a segment's caches carry a leading layer axis.
Unlike the reference, dense decode writes the cache **in place** (the
slot's K/V and position, and ``pos`` advanced by one) and returns it, so a
step costs no copy of the cache.

MLA (``init_mla``, ``mla_apply``; arXiv:2412.19437): the query through the
low-rank ``wdq`` → ``q_norm`` (K7) → ``wuq`` (or one ``wq`` without a q
LoRA), the shared latent ``wdkv`` → ``kv_norm`` (K7), and one RoPE key of
``qk_rope_head_dim`` from ``wkr``, broadcast over the heads. In every mode
as the reference:

* ``mode="train"`` and ``"prefill"``: k = [latent·wuk ; RoPE key], v =
  latent·wuv, q pre-scaled by 1/√(dn + dr) rounded to x's dtype, and K6
  at head_dim dn + dr with v zero-padded to it and the output sliced back
  (the reference's Pallas route, ``attention.py:303-305``; on the CPU the
  plain K6 body on the same padded operands); prefill's cache is the
  latent ``ckv`` (B, S, r), ``krope`` (B, S, dr) and ``pos``;
* ``mode="decode"`` with ``paged=``: the latent rows appended to
  ``pool_ckv`` and ``pool_krope`` in one K10 launch, then the absorbed
  attention (q through wuk into the latent, ``paged_attend_mla``, wuv),
  plain torch on every device as in the reference;
* dense ``mode="decode"``: the absorbed attention against the latent
  cache, whose slot ``min(pos, L - 1)`` and ``pos`` are written in place.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import AttentionConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.models.layers import rope as rope_mod
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm


def init_gqa(b, name: str, d_model: int, cfg: AttentionConfig):
    """Projections fused over (heads × head_dim), as in the reference."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with b.scope(name):
        b.param("wq", (d_model, h * hd))
        b.param("wk", (d_model, kv * hd))
        b.param("wv", (d_model, kv * hd))
        b.param("wo", (h * hd, d_model))
        if cfg.qkv_bias:
            b.param("bq", (h * hd,), init="zeros")
            b.param("bk", (kv * hd,), init="zeros")
            b.param("bv", (kv * hd,), init="zeros")
        if cfg.out_bias:
            b.param("bo", (d_model,), init="zeros")


def init_mla(b, name: str, d_model: int, cfg: AttentionConfig):
    """MLA projections fused over (heads × per-head dims), as in the reference."""
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with b.scope(name):
        if cfg.q_lora_rank:
            b.param("wdq", (d_model, cfg.q_lora_rank))
            init_rmsnorm(b, "q_norm", cfg.q_lora_rank)
            b.param("wuq", (cfg.q_lora_rank, h * (dn + dr)))
        else:
            b.param("wq", (d_model, h * (dn + dr)))
        b.param("wdkv", (d_model, cfg.kv_lora_rank))
        init_rmsnorm(b, "kv_norm", cfg.kv_lora_rank)
        b.param("wuk", (cfg.kv_lora_rank, h * dn))
        b.param("wuv", (cfg.kv_lora_rank, h * dv))
        b.param("wkr", (d_model, dr))
        b.param("wo", (h * dv, d_model))


def init_qk_norm(b, name: str, cfg: AttentionConfig):
    with b.scope(name):
        init_rmsnorm(b, "q_norm", cfg.head_dim)
        init_rmsnorm(b, "k_norm", cfg.head_dim)


@functools.lru_cache(maxsize=None)
def _sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) computed and rounded in ``dtype`` — the reference's
    ``jnp.sqrt(jnp.asarray(n, q.dtype))`` — as a Python float, so scaling q
    makes no host-to-device copy (which would synchronise the stream)."""
    return float(torch.sqrt(torch.tensor(float(n), dtype=dtype)))


@functools.lru_cache(maxsize=None)
def _mla_scale(n: int, dtype: torch.dtype) -> Tuple[float, float]:
    """(1/√n in f32, the same rounded to ``dtype``) as Python floats: the
    reference's f32 ``scale`` and its ``scale.astype(x.dtype)``."""
    s = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    return float(s), float(s.to(dtype))


def _project_qkv(params, cfg: AttentionConfig, x):
    b_, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q.reshape(b_, s, h, hd), k.reshape(b_, s, kv, hd), v.reshape(b_, s, kv, hd)


def _sdpa(q, k, v, *, causal: bool, window: Optional[int], q_offset: int) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D), q pre-scaled -> (B,Sq,H,D) via K6."""
    return fa_ops.flash_attention(q, k, v, causal, window, q_offset)


def gqa_apply(
    params,
    cfg: AttentionConfig,
    x,  # (B, S, d_model)
    cos,
    sin,
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    eps: float = 1e-5,
    qk_norm_params=None,
    paged=None,  # serving.paged_cache.PagedState
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The reference's ``gqa_apply``: ``mode="train"``, ``"prefill"`` (returns
    the dense cache), ``"decode"`` with ``paged=`` (pools updated in place)
    or with a dense ``cache`` (its slot written in place). With
    ``qk_norm_params`` (the block's ``qknorm`` scope), q and k are
    RMS-normalised per head before RoPE."""
    q, k, v = _project_qkv(params, cfg, x)
    if qk_norm_params is not None:
        q = rmsnorm(qk_norm_params["q_norm"], q, eps)
        k = rmsnorm(qk_norm_params["k_norm"], k, eps)
    if cfg.rope != "none" and cos is not None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    q = q / _sqrt_in(cfg.head_dim, q.dtype)
    window = cfg.sliding_window

    new_cache = None
    if mode == "train":
        out = _sdpa(q, k, v, causal=True, window=window, q_offset=0)
    elif mode == "prefill":
        out = _sdpa(q, k, v, causal=True, window=window, q_offset=0)
        new_cache = _init_cache_from_prefill(k, v, window)
    elif mode == "decode" and paged is not None:
        pool_k, pool_v = pa_ops.paged_append_kv_(cache["pool_k"], cache["pool_v"], k, v, paged.page_tables,
                                                 paged.lengths)
        out = pa_ops.paged_attend_gqa(q, pool_k, pool_v, paged.page_tables, paged.lengths, window=window)
        new_cache = cache
    elif mode == "decode":
        if cache is None or "k" not in cache:
            raise ValueError("gqa_apply(mode='decode') needs a dense cache (k, v, positions, pos) or paged=")
        _cache_append(cache, k, v)
        out = _decode_attend(q, cache["k"], cache["v"], positions=cache["positions"], pos=cache["pos"], window=window)
        cache["pos"].add_(1)
        new_cache = cache
    else:
        raise ValueError(f"gqa_apply: unknown mode {mode!r}")

    b_, s = out.shape[0], out.shape[1]
    y = out.to(x.dtype).reshape(b_, s, cfg.num_heads * cfg.head_dim) @ params["wo"]
    if cfg.out_bias:
        y = y + params["bo"]
    return y, new_cache


def mla_apply(
    params,
    cfg: AttentionConfig,
    x,  # (B, S, d_model)
    cos,
    sin,
    *,
    mode: str = "train",
    cache: Optional[dict] = None,
    eps: float = 1e-5,
    paged=None,  # serving.paged_cache.PagedState
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The reference's ``mla_apply`` in every mode (see the module docstring)."""
    b_, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        q = rmsnorm(params["q_norm"], x @ params["wdq"], eps) @ params["wuq"]
    else:
        q = x @ params["wq"]
    q = q.reshape(b_, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], rope_mod.apply_rope(q[..., dn:], cos, sin)
    ckv = rmsnorm(params["kv_norm"], x @ params["wdkv"], eps)  # (B, S, r)
    k_rope = rope_mod.apply_rope((x @ params["wkr"])[:, :, None, :], cos, sin)  # (B, S, 1, dr)
    scale, scale_x = _mla_scale(dn + dr, x.dtype)
    r = cfg.kv_lora_rank

    new_cache = None
    if mode in ("train", "prefill"):
        k_nope = (ckv @ params["wuk"]).reshape(b_, s, h, dn)
        v = (ckv @ params["wuv"]).reshape(b_, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b_, s, h, dr)], dim=-1)
        qcat = torch.cat([q_nope, q_rope], dim=-1) * scale_x
        # v zero-padded to the q/k head dim for the one-D kernel, the output sliced back
        out = fa_ops.flash_attention(qcat, k, F.pad(v, (0, dn + dr - dv)), True, None, 0)[..., :dv]
        if mode == "prefill":
            new_cache = dict(ckv=ckv.contiguous(), krope=k_rope[:, :, 0, :].contiguous(),
                             pos=torch.tensor(s, dtype=torch.int32, device=x.device))
    elif mode == "decode" and paged is not None:
        pa_ops.paged_append_kv_(cache["pool_ckv"], cache["pool_krope"], ckv, k_rope[:, :, 0, :], paged.page_tables,
                                paged.lengths)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"].reshape(r, h, dn))
        o_lat = pa_ops.paged_attend_mla(q_lat, q_rope, cache["pool_ckv"], cache["pool_krope"], paged.page_tables,
                                        paged.lengths, scale=scale)
        out = torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].reshape(r, h, dv).to(torch.float32))
        new_cache = cache
    elif mode == "decode":
        if cache is None or "ckv" not in cache:
            raise ValueError("mla_apply(mode='decode') needs a latent cache (ckv, krope, pos) or paged=")
        pos = cache["pos"]
        slot = torch.clamp(pos, max=cache["ckv"].shape[1] - 1).reshape(1).long()
        cache["ckv"].index_copy_(1, slot, ckv[:, :1].to(cache["ckv"].dtype))
        cache["krope"].index_copy_(1, slot, k_rope[:, :1, 0].to(cache["krope"].dtype))
        # absorb W_uk into q: (B, 1, h, dn) x (r, h, dn) -> (B, 1, h, r)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"].reshape(r, h, dn))
        ckv_all, kr_all = cache["ckv"].to(torch.float32), cache["krope"].to(torch.float32)
        s_nope = torch.einsum("bshr,blr->bhsl", q_lat.to(torch.float32), ckv_all)
        s_rope = torch.einsum("bshk,blk->bhsl", q_rope.to(torch.float32), kr_all)
        scores = (s_nope + s_rope) * scale
        valid = torch.arange(ckv_all.shape[1], device=x.device) <= pos
        scores = scores.masked_fill(~valid, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhsl,blr->bshr", p, ckv_all)
        out = torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].reshape(r, h, dv).to(torch.float32))
        pos.add_(1)
        new_cache = cache
    else:
        raise ValueError(f"mla_apply: unknown mode {mode!r}")

    y = out.to(x.dtype).reshape(b_, out.shape[1], h * dv) @ params["wo"]
    return y, new_cache


# -- dense KV cache (full or a sliding-window ring buffer) ---------------------------


def _init_cache_from_prefill(k, v, window: Optional[int]) -> dict:
    s = k.shape[1]
    if window is not None and s > window:
        k, v = k[:, -window:], v[:, -window:]
    positions = torch.arange(s - k.shape[1], s, dtype=torch.int32, device=k.device)
    return dict(k=k.contiguous(), v=v.contiguous(), positions=positions,
                pos=torch.tensor(s, dtype=torch.int32, device=k.device))


def grow_cache(cache: dict, new_len: int) -> dict:
    """Extend a prefill cache's buffers to ``new_len`` slots (new slots empty:
    zero K/V, position -1; MLA's latent rows zero); recurrent caches are
    returned as they are. Any leading (layer) axes are kept."""
    if "ckv" in cache:  # MLA latent cache
        cur = cache["ckv"].shape[-2]
        if cur >= new_len:
            return cache
        out = dict(cache)
        out["ckv"] = F.pad(cache["ckv"], (0, 0, 0, new_len - cur))
        out["krope"] = F.pad(cache["krope"], (0, 0, 0, new_len - cur))
        return out
    if "k" not in cache:
        return cache
    cur = cache["k"].shape[-3]
    if cur >= new_len:
        return cache
    pad = new_len - cur
    out = dict(cache)
    out["k"] = F.pad(cache["k"], (0, 0, 0, 0, 0, pad))
    out["v"] = F.pad(cache["v"], (0, 0, 0, 0, 0, pad))
    out["positions"] = F.pad(cache["positions"], (0, pad), value=-1)
    return out


def make_decode_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype, device="cpu") -> dict:
    """A cache 'already full' at ``pos = max_len - 1`` for pure-decode runs: a
    warm ring buffer whose slot i holds the most recent absolute position
    congruent to i modulo its length (the window's, under a sliding window);
    MLA's latent cache is zero rows of ``max_len`` at that ``pos``."""
    if cfg.kind == "mla":
        return dict(ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
                    krope=torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
                    pos=torch.tensor(max_len - 1, dtype=torch.int32, device=device))
    window = cfg.sliding_window
    length = min(max_len, window) if window else max_len
    pos = max_len - 1
    idx = torch.arange(length, dtype=torch.int32, device=device)
    positions = pos - torch.remainder(pos - idx, length)
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device),
                positions=positions.to(torch.int32), pos=torch.tensor(pos, dtype=torch.int32, device=device))


def _cache_append(cache: dict, k_new, v_new):
    """Write the new token's K/V and position at its ring slot, in place."""
    pos = cache["pos"]
    slot = torch.remainder(pos, cache["k"].shape[1]).reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new[:, :1].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new[:, :1].to(cache["v"].dtype))
    cache["positions"].index_copy_(0, slot, pos.reshape(1).to(cache["positions"].dtype))


def _decode_attend(q, k, v, *, positions, pos, window: Optional[int]):
    """Single-token attention against the cache, in f32. q: (B,1,H,D); k/v:
    (B,L,Hkv,D); ``positions`` (L,) holds each slot's absolute position (-1
    empty), so one body serves growing caches, warm rings and windows."""
    b, _, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, d)
    scores = torch.einsum("bqhgd,blhd->bhgql", qg.to(torch.float32), k.to(torch.float32))
    valid = (positions >= 0) & (positions <= pos)
    if window is not None:
        valid &= positions > (pos - window)
    scores = scores.masked_fill(~valid, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgql,blhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, 1, h, d)
