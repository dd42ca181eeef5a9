"""Decoder-only transformer (counterpart of ``repro.models.transformer``).

A model is a sequence of *segments*, maximal runs of identical block kinds;
each run keeps its parameters stacked with a leading layer axis, exactly as
the reference does, so JAX's parameter tree transfers leaf for leaf
(:mod:`repro_torch.interop`). The reference's ``lax.scan`` over a run is a
Python loop over its layers here, indexing the stacked weights and pools
(a stacked leaf may also be given as a list of per-layer tensors, which is
how the training loop hands each layer its own gradient window; see
:func:`split_layers`).

Ported for every arch of the reference: ``"attn"`` segments (pre-norm
RMSNorm blocks with SwiGLU or musicgen's GELU MLP with biases, or
command-r's parallel blocks: one bias-free LayerNorm feeding attention and
the FFN, ``x + attn(h) + ffn(h)``, no ``ln2``; GQA attention with optional
QK-norm, or DeepSeek-V3's MLA), ``"moe"`` segments (the same blocks with
the MoE FFN of :mod:`repro_torch.models.layers.moe`; the router's aux loss
is carried across layers as ``moe_aux``), ``"rwkv6"`` segments (RMSNorm,
RWKV-6 time-mix and channel-mix), ``"mamba2"`` segments (RMSNorm, the
Mamba2 SSD block) and ``"shared_attn"`` positions, where the one
weight-shared attention block of the top-level ``shared_block`` scope is
applied (zamba2; it owns no ``seg{i}`` parameters, so the ``seg{i}`` keys
have gaps, and its gradient sums every position's), with tied or untied
embeddings (tied: the head is ``hidden @ tok_emb.T`` and there is no
``head`` leaf), the head's ``logit_scale``, RoPE or Qwen2-VL's M-RoPE
(``positions`` (B, 3, S); without them every stream holds the text
positions), and the two modality frontends as the reference stubs them:

* vision (qwen2-vl): precomputed patch embeddings ``image_embeds`` (B,
  S_img, embed_dim), cast to the parameter dtype, go through the
  ``projector`` (``gelu(img @ w1) @ w2``) and are prepended to the text
  embeddings; attention is causal over the whole sequence, and the loss
  covers the text positions alone;
* audio (musicgen): ``tokens`` (B, K, S) of K codebooks, embedded by the
  (K, V, d) ``tok_emb`` and summed over k = 0 … K-1 in order in the
  parameter dtype; the head is (K, d, V), the logits (B, K, S, V), and the
  loss their mean over every codebook.

``segments``, ``init_model``, ``init_caches``, ``apply_model`` in every
mode (``"train"``, the LM training path: K6 attention, K12 WKV or K11 SSD
scan, K7 norms; ``"prefill"``, which returns the dense caches; ``"decode"``
against the dense caches or, for attention-only text archs, with
``paged=``), ``softmax_xent`` and ``lm_loss`` (with the router term for MoE
archs and DeepSeek-V3's multi-token prediction loss: one ``mtp`` module, an
unstacked scope of ``ln_in``, ``proj`` and one dense ``"attn"`` block,
weight 0.3, off with a frontend as in the reference).

Caches are laid out as the reference's: under ``seg{i}``, each leaf stacked
over the segment's layers (a ``shared_attn`` position's cache unstacked),
so the two packages' caches compare leaf for leaf. Prefill builds them;
dense decode writes every layer's new state into them in place and returns
the same dict.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import mamba2 as mamba_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rope as rope_mod
from repro_torch.models.layers import rwkv6 as rwkv_mod
from repro_torch.models.layers.norms import init_layernorm, init_rmsnorm, layernorm, rmsnorm


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for kind in cfg.pattern():
        if out and out[-1][0] == kind and kind != "shared_attn":
            out[-1] = (kind, out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


_SSM_KINDS = ("rwkv6", "mamba2")


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a configuration outside the reference's
    model: an unknown frontend or segment kind, attention segments without
    an attention config, a recurrent segment whose ``ssm.kind`` is another,
    ``"shared_attn"`` positions without ``shared_attn_every``, ``"moe"``
    segments without a MoE config, M-RoPE sections that do not tile the
    rotary half of the head dim."""
    fe = cfg.frontend
    if fe is not None and fe.kind not in ("vision", "audio"):
        raise ValueError(f"{cfg.name}: unknown frontend kind {fe.kind!r} (vision or audio)")
    kinds = {kind for kind, _ in segments(cfg)}
    other = kinds - {"attn", "moe", "shared_attn", *_SSM_KINDS}
    if other:
        raise ValueError(f"{cfg.name}: unknown segment kinds {sorted(other)}")
    for kind in kinds & set(_SSM_KINDS):
        if cfg.ssm is None or cfg.ssm.kind != kind:
            raise ValueError(f"{cfg.name}: {kind} segments take ssm.kind {kind!r}")
    if "shared_attn" in kinds and not cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: shared_attn positions need shared_attn_every (the shared_block scope)")
    if "moe" in kinds and cfg.moe is None:
        raise ValueError(f"{cfg.name}: moe segments need a MoE config")
    a = cfg.attention
    if a is None and kinds & {"attn", "moe", "shared_attn"}:
        raise ValueError(f"{cfg.name}: attention segments need an attention config")
    if a is not None and a.rope == "mrope":
        half = (a.qk_rope_head_dim if a.kind == "mla" else a.head_dim) // 2
        if sum(a.mrope_sections) != half:
            raise ValueError(f"{cfg.name}: M-RoPE sections {tuple(a.mrope_sections)} must sum to {half}")


def _init_block(b, cfg: ModelConfig, kind: str):
    d = cfg.d_model
    if kind in ("attn", "moe", "shared_attn"):
        (init_layernorm if cfg.use_parallel_block else init_rmsnorm)(b, "ln1", d)
        if cfg.attention.kind == "mla":
            attn_mod.init_mla(b, "attn", d, cfg.attention)
        else:
            attn_mod.init_gqa(b, "attn", d, cfg.attention)
            if cfg.use_qk_norm:
                attn_mod.init_qk_norm(b, "qknorm", cfg.attention)
        if not cfg.use_parallel_block:
            init_rmsnorm(b, "ln2", d)
        if kind == "moe":
            moe_mod.init_moe(b, "ffn", d, cfg.moe)
        elif cfg.act == "gelu":
            mlp_mod.init_gelu_mlp(b, "ffn", d, cfg.d_ff)
        else:
            mlp_mod.init_swiglu(b, "ffn", d, cfg.d_ff)
    elif kind == "rwkv6":
        init_rmsnorm(b, "ln1", d)
        init_rmsnorm(b, "ln2", d)
        rwkv_mod.init_rwkv6(b, "tm", d, cfg.ssm)
        rwkv_mod.init_rwkv6_ffn(b, "cm", d, cfg.d_ff)
    elif kind == "mamba2":
        init_rmsnorm(b, "ln1", d)
        mamba_mod.init_mamba2(b, "block", d, cfg.ssm)
    else:
        raise ValueError(kind)


def init_model(cfg: ModelConfig, generator: torch.Generator, device="cpu") -> dict:
    """Parameters as nested dicts of tensors on ``device``, each stacked
    segment under ``seg{i}`` with a leading layer axis, the shared attention
    block (if any) under ``shared_block``, the multi-token prediction module
    (if any) under ``mtp``, the vision ``projector`` (``w1`` (embed_dim, d),
    ``w2`` (d, d)) with a vision frontend, and no ``head`` when the
    embeddings are tied. An audio frontend's ``tok_emb`` is (K, V, d) and
    its ``head`` (K, d, V)."""
    _check_supported(cfg)
    b = P.Builder(generator, cfg.param_dtype, device)
    d = cfg.d_model
    fe = cfg.frontend
    audio = fe is not None and fe.kind == "audio"
    b.param("tok_emb", ((fe.num_codebooks,) if audio else ()) + (cfg.vocab_size, d), init="normal")
    if fe is not None and fe.kind == "vision":
        with b.scope("projector"):
            b.param("w1", (fe.embed_dim, d))
            b.param("w2", (d, d))
    init_rmsnorm(b, "final_norm", d)
    if not cfg.tie_embeddings:
        b.param("head", ((fe.num_codebooks,) if audio else ()) + (d, cfg.vocab_size))
    if cfg.shared_attn_every:
        with b.scope("shared_block"):
            _init_block(b, cfg, "shared_attn")
    if cfg.mtp_depth:
        with b.scope("mtp"):
            init_rmsnorm(b, "ln_in", d)
            b.param("proj", (2 * d, d))
            _init_block(b, cfg, "attn")
    params = b.params
    for si, (kind, n) in enumerate(segments(cfg)):
        if kind == "shared_attn":
            continue
        sb = P.Builder(generator, cfg.param_dtype, device, lead=(n,))
        _init_block(sb, cfg, kind)
        params[f"seg{si}"] = sb.params
    return params


def _layer(tree, i: int):
    """Layer i of a stacked subtree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def split_layers(path: Tuple[str, ...], leaf: torch.Tensor):
    """A stacked segment leaf (key path ``("seg{i}", ...)``) as the list of
    its per-layer views, any other leaf as it is. The training loop makes
    each piece its own autograd leaf, so the backward of layer i writes
    into layer i's window of the gradient plane instead of a zero-filled
    copy of the whole stack."""
    return list(leaf.unbind(0)) if path[0].startswith("seg") else leaf


def _ffn(cfg: ModelConfig, kind: str, prm, h, mode: str):
    """(the block's FFN of h, its router stats or None). The MoE's capacity
    factor: the config's in training, 4.0 when serving."""
    if kind == "moe":
        return moe_mod.moe_apply(prm, cfg.moe, h, cfg.act, capacity_factor=0.0 if mode == "train" else 4.0)
    if cfg.act == "gelu":
        return mlp_mod.gelu_mlp(prm, h), None
    return mlp_mod.swiglu(prm, h, cfg.act), None


def _apply_block(cfg: ModelConfig, kind: str, prm, x, cos, sin, *, mode, cache, eps, paged):
    """(x, the block's new cache: None in train mode, its router stats: None
    unless ``kind`` is ``"moe"``)."""
    if kind == "rwkv6":
        h = rmsnorm(prm["ln1"], x, eps)
        y, tm_cache = rwkv_mod.rwkv6_timemix_apply(prm["tm"], cfg.ssm, h, mode=mode, cache=cache, eps=eps)
        x = x + y
        h2 = rmsnorm(prm["ln2"], x, eps)
        y2, cm_cache = rwkv_mod.rwkv6_channelmix_apply(prm["tm"], prm["cm"], h2, cache=cache)
        # prefill: the channel-mix ran without a cache; decode: both wrote the one cache in place
        new_cache = dict(tm_cache, cm_last=h2[:, -1]) if mode == "prefill" else cm_cache
        return x + y2, new_cache, None
    if kind == "mamba2":
        h = rmsnorm(prm["ln1"], x, eps)
        y, new_cache = mamba_mod.mamba2_apply(prm["block"], cfg.ssm, h, mode=mode, cache=cache, eps=eps)
        return x + y, new_cache, None
    if cfg.attention.kind == "mla":
        def attend(h):
            return attn_mod.mla_apply(prm["attn"], cfg.attention, h, cos, sin, mode=mode, cache=cache, eps=eps,
                                      paged=paged)
    else:
        def attend(h):
            return attn_mod.gqa_apply(prm["attn"], cfg.attention, h, cos, sin, mode=mode, cache=cache, eps=eps,
                                      qk_norm_params=prm.get("qknorm"), paged=paged)
    if cfg.use_parallel_block:  # command-r: x + attn(ln(x)) + ffn(ln(x))
        h = layernorm(prm["ln1"], x, eps)
        y_attn, new_cache = attend(h)
        y_ffn, stats = _ffn(cfg, kind, prm["ffn"], h, mode)
        return x + y_attn + y_ffn, new_cache, stats
    h = rmsnorm(prm["ln1"], x, eps)
    y, new_cache = attend(h)
    x = x + y
    y2, stats = _ffn(cfg, kind, prm["ffn"], rmsnorm(prm["ln2"], x, eps), mode)
    return x + y2, new_cache, stats


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device="cpu") -> dict:
    """Preallocated per-segment dense caches for pure-decode runs (attention
    caches 'full' at ``pos = max_len - 1``), stacked over each segment's
    layers as the reference lays them out."""
    _check_supported(cfg)
    dtype = dtype or cfg.param_dtype
    caches: Dict[str, Any] = {}
    for si, (kind, n) in enumerate(segments(cfg)):
        one = _init_block_cache(cfg, kind, batch, max_len, dtype, device)
        if kind == "shared_attn":
            caches[f"seg{si}"] = one
        else:
            caches[f"seg{si}"] = {k: t[None].repeat((n,) + (1,) * t.dim()) for k, t in one.items()}
    return caches


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype, device):
    if kind in ("attn", "moe", "shared_attn"):
        return attn_mod.make_decode_cache(batch, max_len, cfg.attention, dtype, device=device)
    if kind == "mamba2":
        return mamba_mod.make_mamba_cache(batch, cfg.d_model, cfg.ssm, dtype, device=device)
    if kind == "rwkv6":
        return rwkv_mod.make_rwkv_cache(batch, cfg.d_model, cfg.ssm, dtype, device=device)
    raise ValueError(kind)


def _embed(cfg: ModelConfig, params, inputs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x (B, S, d) in the parameter dtype, the loss mask: False over the
    image positions and True over the text when ``image_embeds`` are given,
    else None). Each embedding is a row gather; its backward on the card
    (embedding_dense_backward) sums repeated tokens in a fixed order, so
    replays are bitwise."""
    fe = cfg.frontend
    toks = inputs["tokens"].long()
    if fe is not None and fe.kind == "audio":  # (B, K, S): one table a codebook, summed in order
        emb = params["tok_emb"]
        x = F.embedding(toks[:, 0], emb[0])
        for k in range(1, fe.num_codebooks):
            x = x + F.embedding(toks[:, k], emb[k])
        return x.to(cfg.param_dtype), None
    x = F.embedding(toks, params["tok_emb"])
    if fe is None or fe.kind != "vision" or "image_embeds" not in inputs:
        return x.to(cfg.param_dtype), None
    img = inputs["image_embeds"].to(cfg.param_dtype)  # (B, S_img, embed_dim)
    proj = params["projector"]
    x = torch.cat([mlp_mod.gelu(img @ proj["w1"]) @ proj["w2"], x], dim=1)
    b_, s_img = img.shape[0], img.shape[1]
    mask = torch.cat([torch.zeros((b_, s_img), dtype=torch.bool, device=x.device),
                      torch.ones((b_, toks.shape[1]), dtype=torch.bool, device=x.device)], dim=1)
    return x.to(cfg.param_dtype), mask


def _rope_for(cfg: ModelConfig, inputs, batch: int, seq: int, offset=0):
    """cos/sin over the head dim (MLA: its RoPE part, ``qk_rope_head_dim``);
    M-RoPE from ``positions`` (B, 3, S), or the text positions in all three
    streams."""
    a = cfg.attention
    if a is None or a.rope == "none":
        return None, None
    dim = a.qk_rope_head_dim if a.kind == "mla" else a.head_dim
    pos = inputs.get("positions")
    device = inputs["tokens"].device
    if a.rope == "mrope":
        if pos is None:
            pos = rope_mod.text_mrope_positions(batch, seq, offset, device=device)
        return rope_mod.mrope_cos_sin(pos, dim, a.rope_theta, a.mrope_sections)
    if pos is None:
        pos = rope_mod.text_positions(batch, seq, offset, device=device)
    return rope_mod.rope_cos_sin(pos, dim, a.rope_theta)


def _head(cfg: ModelConfig, params, hidden):
    fe = cfg.frontend
    if fe is not None and fe.kind == "audio":  # one head a codebook: (B, K, S, V)
        logits = torch.einsum("bsd,kdv->bksv", hidden, params["head"])
    else:
        logits = hidden @ (params["tok_emb"].T if cfg.tie_embeddings else params["head"])
    return logits * cfg.logit_scale


def apply_model(
    cfg: ModelConfig,
    params: dict,
    inputs: dict,
    *,
    mode: str = "train",
    caches: Optional[Dict[str, Any]] = None,
    decode_pos=None,
    paged=None,
) -> Tuple[torch.Tensor, dict]:
    """Returns (logits, aux) with aux ``caches``, ``hidden``, ``moe_aux``
    (0-dim f32: the sum over MoE layers of the router's aux loss; zero
    without MoE) and ``loss_mask`` (see :func:`_embed`).

    ``mode="train"``: ``inputs`` holds ``tokens`` (B, S), or (B, K, S) with
    an audio frontend, and, with a vision frontend, optionally
    ``image_embeds`` (B, S_img, embed_dim), prepended; M-RoPE archs may pass
    ``positions`` (B, 3, S). Causal attention over the whole sequence, no
    caches. ``mode="prefill"``: the same forward,
    and ``aux["caches"]`` the new dense caches. ``mode="decode"`` with
    ``paged``: ``inputs`` holds ``tokens`` (S, T) and per-row ``positions``
    (S, T); ``caches`` the per-segment page pools, updated in place.
    ``mode="decode"`` without ``paged``: ``tokens`` (B, 1) (audio: (B, K,
    1)) at absolute position ``decode_pos`` (an int or a 0-dim tensor) against the dense
    ``caches``, updated in place and returned."""
    _check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"apply_model: unknown mode {mode!r}")
    dense_decode = mode == "decode" and paged is None
    if dense_decode and not caches:
        raise ValueError("apply_model(mode='decode') needs the dense caches (from prefill or init_caches) or paged=")
    x, loss_mask = _embed(cfg, params, inputs)
    b_, s = x.shape[0], x.shape[1]
    cos, sin = _rope_for(cfg, inputs, b_, s, decode_pos if dense_decode else 0)
    eps = cfg.norm_eps
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for si, (kind, n) in enumerate(segments(cfg)):
        key = f"seg{si}"
        seg_cache = caches.get(key) if caches else None
        if kind == "shared_attn":  # the one shared block, at every shared_attn position
            x, nc, _ = _apply_block(cfg, kind, params["shared_block"], x, cos, sin, mode=mode, cache=seg_cache,
                                    eps=eps, paged=paged)
            if mode == "prefill":
                new_caches[key] = nc
            continue
        seg_params = params[key]
        layer_caches = []
        for i in range(n):
            cache = _layer(seg_cache, i) if seg_cache is not None else None
            x, nc, stats = _apply_block(cfg, kind, _layer(seg_params, i), x, cos, sin, mode=mode, cache=cache,
                                        eps=eps, paged=paged)
            if stats is not None:  # the reference's scan carry, layer by layer
                moe_aux = moe_aux + stats["aux_loss"]
            if mode == "prefill":
                layer_caches.append(nc)
        if mode == "prefill":  # stacked over the segment's layers, as the reference's scan stacks them
            new_caches[key] = {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
    hidden = rmsnorm(params["final_norm"], x, eps)
    out_caches = new_caches if mode == "prefill" else (caches or {})
    return _head(cfg, params, hidden), dict(caches=out_caches, hidden=hidden, moe_aux=moe_aux, loss_mask=loss_mask)


def softmax_xent(logits, targets) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 over every leading position
    (the reference's ``softmax_xent`` without the loss mask, which its
    ``lm_loss`` never passes)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def lm_loss(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, dict]:
    """``batch``: dict(tokens=(B, S), targets=(B, S)) -> (loss, metrics), as
    the reference's ``lm_loss``: audio ``tokens`` and ``targets`` are (B, K,
    S) and the loss the mean over codebooks too; a vision batch may add
    ``image_embeds`` and the loss is taken over the last S logits (the
    text); with MoE the loss adds ``router_aux_weight * moe_aux /
    num_layers`` and the metrics hold ``moe_aux``; with multi-token
    prediction and no frontend it adds ``0.3 * mtp`` and the metrics hold
    ``mtp`` (:func:`_mtp_loss`)."""
    logits, aux = apply_model(cfg, params, batch, mode="train")
    fe, targets = cfg.frontend, batch["targets"]
    if fe is not None and fe.kind == "vision":  # the logits cover [image ; text]
        logits = logits[:, -targets.shape[1]:]
    xent = softmax_xent(logits, targets)
    metrics = dict(xent=xent)
    loss = xent
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux["moe_aux"] / max(cfg.num_layers, 1)
        metrics["moe_aux"] = aux["moe_aux"]
    if cfg.mtp_depth and fe is None:
        mtp = _mtp_loss(cfg, params, batch, aux["hidden"])
        loss = loss + 0.3 * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg: ModelConfig, params, batch, hidden) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction, as the reference's: predict
    token t + 2 from [ln_in(h_t) ; emb(token t + 1)] through ``proj``, the
    module's ``"attn"`` block and the shared head, scored against
    ``targets[:, 1:]``. ``tok_emb`` gets gradient from this gather too, and
    ``head`` from both heads."""
    tgt = batch["targets"]
    emb_next = F.embedding(tgt.long(), params["tok_emb"])  # the embedding of token t + 1
    mtp = params["mtp"]
    h = rmsnorm(mtp["ln_in"], hidden, cfg.norm_eps)
    z = torch.cat([h[:, :-1], emb_next[:, :-1].to(h.dtype)], dim=-1) @ mtp["proj"]
    cos, sin = _rope_for(cfg, dict(tokens=tgt), z.shape[0], z.shape[1])
    z, _, _ = _apply_block(cfg, "attn", mtp, z, cos, sin, mode="train", cache=None, eps=cfg.norm_eps, paged=None)
    return softmax_xent(_head(cfg, params, z), tgt[:, 1:])
