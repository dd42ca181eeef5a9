"""Mixture-of-Experts FFN with top-k routing (counterpart of
``repro.models.layers.moe``).

Both MoE styles of the reference:

* Arctic — 128 experts top-2 behind a softmax router, with a dense SwiGLU
  FFN in parallel (``dense_residual_ff``);
* DeepSeek-V3's routing — a sigmoid router with normalised top-k gates and
  shared experts (``num_shared_experts``).

The router is f32 in a model of any dtype (its logits are f32), so a bf16
model's plane has two dtype buckets. Dispatch is the reference's capacity
scheme: each token's k experts are ranked first-come within each expert's
buffer of ``capacity`` slots; a token past its expert's capacity is dropped
(its gate zeroed, its slot the overflow row ``e * capacity``, which is cut
off; several dropped tokens may write that row, every other slot is written
once). The token ids are scattered into the slot table, the hidden rows
gathered from it, the experts run as three batched matmuls over the expert
axis (the reference's einsums, outside any Pallas kernel), and each token
gathers its k slots back, weighted by its gates in f32. The experts, the
shared experts and the dense residual are SwiGLU, gated by SiLU for ``act``
"silu" and by GELU otherwise, as the reference's.

The top-k is a stable descending sort of the router's scores: on equal
scores the lower expert index comes first, as ``jax.lax.top_k`` orders them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.models.layers.mlp import gelu, init_swiglu, swiglu


def init_moe(b, name: str, d_model: int, cfg: MoEConfig):
    e, f = cfg.num_experts, cfg.expert_ff
    with b.scope(name):
        b.param("router", (d_model, e), init="normal", scale=0.02, dtype=torch.float32)
        b.param("wi_gate", (e, d_model, f))
        b.param("wi_up", (e, d_model, f))
        b.param("wo", (e, f, d_model))
        if cfg.num_shared_experts:
            init_swiglu(b, "shared", d_model, cfg.shared_expert_ff * cfg.num_shared_experts)
        if cfg.dense_residual_ff:
            init_swiglu(b, "dense_residual", d_model, cfg.dense_residual_ff)


def capacity_of(tokens: int, cfg: MoEConfig, capacity_factor: float = 0.0) -> int:
    """Slots an expert's buffer holds for ``tokens`` tokens: the reference's
    ``max(k, round(T k / E cf))``, at most T (a token uses an expert once)."""
    cf = capacity_factor if capacity_factor > 0 else cfg.capacity_factor
    k, e = cfg.top_k, cfg.num_experts
    return min(int(max(k, round(tokens * k / e * cf))), tokens)


def route(params, cfg: MoEConfig, xt):
    """The router on tokens ``xt`` (T, d): (probs, gates, idx), probs (T, E)
    and gates (T, k) f32, idx (T, k) the chosen experts in descending score
    order. A bf16 router (a consensus cast to the model dtype) is widened
    to f32 first, as JAX promotes it."""
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    k = cfg.top_k
    if cfg.num_shared_experts:  # deepseek-style sigmoid router, normalised gates
        scores = torch.sigmoid(logits)
        gate_vals, idx = _top_k(scores, k)
        gates = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:  # softmax router (arctic)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, idx = _top_k(probs, k)
        gates = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def _top_k(scores, k: int):
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_apply(params, cfg: MoEConfig, x, act: str = "silu", capacity_factor: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, router stats). ``capacity_factor`` overrides
    ``cfg.capacity_factor`` when > 0 (serving uses 4.0, so prefill and decode
    are in effect dropless). The stats: ``aux_loss`` (the switch-style load
    balance term), ``load`` (each expert's share of assignments, normalised
    to 1 at balance), ``mean_prob`` and ``dropped`` (the share of the
    token-expert assignments past capacity), all f32."""
    b_, s, d = x.shape
    t = b_ * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d)
    probs, gates, idx = route(params, cfg, xt)
    capacity = capacity_of(t, cfg, capacity_factor)

    assigned = F.one_hot(idx, e).sum(1)  # (T, E) 0/1
    # position of each token within its expert's buffer (first-come order)
    pos_in_expert = torch.cumsum(assigned, dim=0) - assigned
    pos_k = torch.gather(pos_in_expert, 1, idx)  # (T, k)
    keep = pos_k < capacity
    gates = torch.where(keep, gates, torch.zeros((), dtype=gates.dtype, device=gates.device))
    flat_slot = torch.where(keep, idx * capacity + pos_k, torch.full_like(idx, e * capacity))  # overflow -> cut row

    # dispatch: token ids into the slot table, then the hidden rows gathered
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.long, device=x.device)
    token_ids = torch.arange(t, device=x.device)[:, None].expand(t, k)
    slot_token[flat_slot.reshape(-1)] = token_ids.reshape(-1)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    buf = xt_pad[slot_token[: e * capacity]].reshape(e, capacity, d)

    # the experts: batched matmuls over the expert axis
    g = torch.bmm(buf, params["wi_gate"])
    u = torch.bmm(buf, params["wi_up"])
    y = torch.bmm((F.silu(g) if act == "silu" else gelu(g)) * u, params["wo"])

    # combine: each token's k slots, weighted by its gates in f32
    y_flat = torch.cat([y.reshape(e * capacity, d), y.new_zeros((1, d))], dim=0)
    gathered = y_flat[flat_slot]  # (T, k, d)
    out = torch.einsum("tkd,tk->td", gathered.to(torch.float32), gates.to(torch.float32)).to(x.dtype)
    out = out.reshape(b_, s, d)

    if cfg.num_shared_experts:
        out = out + swiglu(params["shared"], x, act)
    if cfg.dense_residual_ff:
        out = out + swiglu(params["dense_residual"], x, act)

    # switch-style aux loss: E * sum_e f_e * p_e
    frac_tokens = assigned.to(torch.float32).mean(0) * (e / k)  # load fraction (normalised)
    mean_prob = probs.mean(0)
    aux = e * torch.sum(frac_tokens / e * mean_prob) * k
    stats = dict(aux_loss=aux, load=frac_tokens, mean_prob=mean_prob,
                 dropped=1.0 - torch.mean(keep.to(torch.float32)))
    return out, stats
