"""Grouped-query attention, paged decode path (counterpart of the GQA parts
of ``repro.models.layers.attention``).

The serving slice ports ``init_gqa``, ``_project_qkv`` (with ``qkv_bias``),
the pre-scaling ``q / sqrt(head_dim)`` in the activation dtype, and the
paged decode branch: append K, append V (kernel K10, in place), then attend
(kernel K9 for one token per slot; the plain chunked-prefill body for T > 1).
MLA and the dense train/prefill/decode paths come in later slices.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.config.base import AttentionConfig
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.models.layers import rope as rope_mod


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


@functools.lru_cache(maxsize=None)
def _sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) computed and rounded in ``dtype`` — the reference's
    ``jnp.sqrt(jnp.asarray(n, q.dtype))`` — as a Python float, so scaling q
    makes no host-to-device copy (which would synchronise the stream)."""
    return float(torch.sqrt(torch.tensor(float(n), dtype=dtype)))


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


def gqa_apply(
    params,
    cfg: AttentionConfig,
    x,  # (B, S, d_model)
    cos,
    sin,
    *,
    cache: dict,
    paged,  # serving.paged_cache.PagedState
) -> Tuple[torch.Tensor, dict]:
    """Paged decode: the reference's ``gqa_apply(mode="decode", paged=...)``."""
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.rope != "none" and cos is not None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    q = q / _sqrt_in(cfg.head_dim, q.dtype)
    window = cfg.sliding_window

    pool_k = pa_ops.paged_append_(cache["pool_k"], k, paged.page_tables, paged.lengths)
    pool_v = pa_ops.paged_append_(cache["pool_v"], v, paged.page_tables, paged.lengths)
    out = pa_ops.paged_attend_gqa(q, pool_k, pool_v, paged.page_tables, paged.lengths, window=window)

    b_, s = out.shape[0], out.shape[1]
    y = out.to(x.dtype).reshape(b_, s, cfg.num_heads * cfg.head_dim) @ params["wo"]
    if cfg.out_bias:
        y = y + params["bo"]
    return y, cache
