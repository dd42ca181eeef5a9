"""Grouped-query attention (counterpart of the GQA parts of
``repro.models.layers.attention``).

Ported: ``init_gqa``, ``_project_qkv`` (with ``qkv_bias``), the pre-scaling
``q / sqrt(head_dim)`` in the activation dtype, and two modes of
``gqa_apply``:

* ``mode="train"``: causal (optionally windowed) attention over the whole
  sequence through ``_sdpa``, which is kernel K6 (``flash_attention``,
  forward and backward kernels) for CUDA tensors and its plain version for
  CPU tensors;
* ``mode="decode"`` with ``paged=``: append K, append V (kernel K10, in
  place), then attend (kernel K9 for one token per slot; the plain
  chunked-prefill body for T > 1).

MLA, prefill caches and the dense decode path come in later slices.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.config.base import AttentionConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
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
    paged=None,  # serving.paged_cache.PagedState
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The reference's ``gqa_apply`` for ``mode="train"`` and for
    ``mode="decode"`` with ``paged=`` (pools updated in place)."""
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.rope != "none" and cos is not None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    q = q / _sqrt_in(cfg.head_dim, q.dtype)
    window = cfg.sliding_window

    if mode == "train":
        out = _sdpa(q, k, v, causal=True, window=window, q_offset=0)
    elif mode == "decode" and paged is not None:
        pool_k = pa_ops.paged_append_(cache["pool_k"], k, paged.page_tables, paged.lengths)
        pool_v = pa_ops.paged_append_(cache["pool_v"], v, paged.page_tables, paged.lengths)
        out = pa_ops.paged_attend_gqa(q, pool_k, pool_v, paged.page_tables, paged.lengths, window=window)
    else:
        raise NotImplementedError(f"gqa_apply(mode={mode!r}, paged={paged is not None}): prefill caches and the "
                                  "dense decode path are ROADMAP Queue 1 item 7")

    b_, s = out.shape[0], out.shape[1]
    y = out.to(x.dtype).reshape(b_, s, cfg.num_heads * cfg.head_dim) @ params["wo"]
    if cfg.out_bias:
        y = y + params["bo"]
    return y, cache
