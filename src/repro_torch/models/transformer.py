"""Decoder-only transformer, serving slice (counterpart of
``repro.models.transformer``).

A model is a sequence of *segments*, maximal runs of identical block kinds;
each run keeps its parameters stacked with a leading layer axis, exactly as
the reference does, so JAX's parameter tree transfers leaf for leaf
(:mod:`repro_torch.interop`). The reference's ``lax.scan`` over a run is a
Python loop over its layers here, indexing the stacked weights and pools.

Ported: ``segments``, ``init_model`` and ``apply_model(mode="decode",
paged=...)`` for ``"attn"`` segments of GQA text archs (pre-norm RMSNorm
blocks with SwiGLU), with ``_embed``, ``_rope_for`` and ``_head``. MoE, SSM,
shared-attention, frontends, MTP and the dense train/prefill/decode modes
come in later slices and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers import rope as rope_mod
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for kind in cfg.pattern():
        if out and out[-1][0] == kind and kind != "shared_attn":
            out[-1] = (kind, out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


def _check_supported(cfg: ModelConfig) -> None:
    a = cfg.attention
    if cfg.frontend is not None or a is None or a.kind != "gqa" or a.rope == "mrope":
        raise NotImplementedError(f"{cfg.name}: the port covers GQA text archs (no frontend, no M-RoPE)")
    if cfg.use_parallel_block or cfg.use_qk_norm or cfg.act != "silu" or cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: parallel blocks, QK-norm, GELU MLPs and tied embeddings come later")
    kinds = {kind for kind, _ in segments(cfg)}
    if kinds != {"attn"}:
        raise NotImplementedError(f"{cfg.name}: segment kinds {sorted(kinds)}; the port covers 'attn' only")


def _init_block(b, cfg: ModelConfig):
    d = cfg.d_model
    init_rmsnorm(b, "ln1", d)
    attn_mod.init_gqa(b, "attn", d, cfg.attention)
    init_rmsnorm(b, "ln2", d)
    mlp_mod.init_swiglu(b, "ffn", d, cfg.d_ff)


def init_model(cfg: ModelConfig, generator: torch.Generator, device="cpu") -> dict:
    """Parameters as nested dicts of tensors on ``device``, each stacked
    segment under ``seg{i}`` with a leading layer axis."""
    _check_supported(cfg)
    b = P.Builder(generator, cfg.param_dtype, device)
    d = cfg.d_model
    b.param("tok_emb", (cfg.vocab_size, d), init="normal")
    init_rmsnorm(b, "final_norm", d)
    b.param("head", (d, cfg.vocab_size))
    params = b.params
    for si, (kind, n) in enumerate(segments(cfg)):
        sb = P.Builder(generator, cfg.param_dtype, device, lead=(n,))
        _init_block(sb, cfg)
        params[f"seg{si}"] = sb.params
    return params


def _layer(tree, i: int):
    """Layer i of a stacked subtree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(cfg: ModelConfig, prm, x, cos, sin, *, cache, eps, paged):
    h = rmsnorm(prm["ln1"], x, eps)
    y, cache = attn_mod.gqa_apply(prm["attn"], cfg.attention, h, cos, sin, cache=cache, paged=paged)
    x = x + y
    h2 = rmsnorm(prm["ln2"], x, eps)
    return x + mlp_mod.swiglu(prm["ffn"], h2)


def _embed(cfg: ModelConfig, params, inputs) -> torch.Tensor:
    toks = inputs["tokens"]
    return params["tok_emb"][toks.long()].to(cfg.param_dtype)


def _rope_for(cfg: ModelConfig, inputs, batch: int, seq: int, offset=0):
    a = cfg.attention
    if a is None or a.rope == "none":
        return None, None
    pos = inputs.get("positions")
    if pos is None:
        dev = inputs["tokens"].device
        pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :].expand(batch, seq) + offset
    return rope_mod.rope_cos_sin(pos, a.head_dim, a.rope_theta)


def _head(cfg: ModelConfig, params, hidden):
    return (hidden @ params["head"]) * cfg.logit_scale


def apply_model(
    cfg: ModelConfig,
    params: dict,
    inputs: dict,
    *,
    mode: str = "decode",
    caches: Dict[str, Any],
    paged,
) -> Tuple[torch.Tensor, dict]:
    """Paged decode forward: ``inputs`` holds ``tokens`` (S, T) and per-row
    ``positions`` (S, T); ``caches`` the per-segment page pools, updated in
    place. Returns (logits, aux) with aux ``caches`` and ``hidden``."""
    if mode != "decode" or paged is None:
        raise NotImplementedError("the port serves the paged decode path only (mode='decode', paged=...)")
    _check_supported(cfg)
    x = _embed(cfg, params, inputs)
    b_, s = x.shape[0], x.shape[1]
    cos, sin = _rope_for(cfg, inputs, b_, s)
    eps = cfg.norm_eps
    for si, (_, n) in enumerate(segments(cfg)):
        seg_params, seg_cache = params[f"seg{si}"], caches[f"seg{si}"]
        for i in range(n):
            x = _apply_block(
                cfg, _layer(seg_params, i), x, cos, sin, cache=_layer(seg_cache, i), eps=eps, paged=paged
            )
    hidden = rmsnorm(params["final_norm"], x, eps)
    return _head(cfg, params, hidden), dict(caches=caches, hidden=hidden)
