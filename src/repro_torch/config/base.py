"""Model configuration dataclasses (counterpart of ``repro.config.base``).

A copy, not an import: the JAX module pulls in ``jax.numpy``, and this
package never imports JAX. Fields and defaults are identical to the
reference, so ``dataclasses.asdict`` of a port config equals that of the
JAX config for the same arch; the one difference is that
:attr:`ModelConfig.param_dtype` is a ``torch.dtype``.

Here are the layer configs that ``ModelConfig.reduced`` touches,
``ModelConfig`` itself, the ``ArchConfig``/``ParallelPlan``/``InputShape``
entries the registry stores, and the training configs ``AlgoConfig`` and
``OptimizerConfig`` (the reference's ``config/base.py:288-348``, same fields
and defaults).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# ---------------------------------------------------------------------------
# Layer-level configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """Multi-head attention (GQA / MHA / MLA)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "gqa"  # "gqa" | "mla"
    qkv_bias: bool = False
    out_bias: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full causal
    rope: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE (t, h, w) split of head_dim/2
    # MLA (DeepSeek-V3) dimensions
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    num_experts: int
    top_k: int
    expert_ff: int
    num_shared_experts: int = 0
    shared_expert_ff: int = 0
    dense_residual_ff: int = 0
    router_aux_weight: float = 0.01
    router_dtype: str = "float32"
    capacity_factor: float = 1.25
    first_k_dense: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence blocks (Mamba2 SSD, RWKV6 WKV)."""

    kind: str  # "mamba2" | "rwkv6"
    state_dim: int = 64
    num_heads: int = 0
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 64


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend (VLM vision tower / audio codec)."""

    kind: str  # "vision" | "audio"
    embed_dim: int
    tokens_per_item: int
    num_codebooks: int = 1


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


def _mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    half = head_dim // 2
    t = half // 2
    h = half // 4
    return (t, h, half - t - h)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    layer_pattern: Tuple[str, ...] = ()  # default: ("attn",) * num_layers
    norm_eps: float = 1e-5
    act: str = "silu"
    use_parallel_block: bool = False
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    logit_scale: float = 1.0
    mtp_depth: int = 0
    shared_attn_every: int = 0
    dtype: str = "bfloat16"
    source: str = ""

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        return ("attn",) * self.num_layers

    @property
    def param_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts — the
        same rules as the reference, so both packages build the same shapes."""
        d_model = min(self.d_model, 256)
        scale = d_model / self.d_model
        heads = None
        if self.attention is not None:
            a = self.attention
            num_heads = max(2, min(4, a.num_heads))
            num_kv = max(1, min(num_heads, a.num_kv_heads))
            head_dim = max(16, d_model // num_heads)
            if a.kind == "mla":
                heads = replace(
                    a,
                    num_heads=num_heads,
                    num_kv_heads=num_heads,
                    head_dim=head_dim,
                    q_lora_rank=64,
                    kv_lora_rank=64,
                    qk_nope_head_dim=head_dim,
                    qk_rope_head_dim=16,
                    v_head_dim=head_dim,
                )
            else:
                heads = replace(
                    a,
                    num_heads=num_heads,
                    num_kv_heads=num_kv,
                    head_dim=head_dim,
                    sliding_window=(64 if a.sliding_window else None),
                    mrope_sections=_mrope_sections(head_dim) if a.rope == "mrope" else (),
                )
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                expert_ff=max(32, int(self.moe.expert_ff * scale)),
                num_shared_experts=min(1, self.moe.num_shared_experts),
                shared_expert_ff=max(32, int(self.moe.shared_expert_ff * scale)) if self.moe.shared_expert_ff else 0,
                dense_residual_ff=max(32, int(self.moe.dense_residual_ff * scale)) if self.moe.dense_residual_ff else 0,
                first_k_dense=min(1, self.moe.first_k_dense),
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(
                self.ssm,
                state_dim=min(16, self.ssm.state_dim),
                num_heads=max(2, min(4, self.ssm.num_heads)),
                head_dim=max(16, min(32, self.ssm.head_dim)),
                chunk_size=16,
            )
        n_layers = 2
        pattern = self._reduced_pattern(n_layers)
        frontend = None
        if self.frontend is not None:
            frontend = replace(
                self.frontend,
                embed_dim=min(128, self.frontend.embed_dim),
                tokens_per_item=min(16, self.frontend.tokens_per_item),
            )
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d_model,
            d_ff=max(64, int(self.d_ff * scale)),
            vocab_size=min(512, self.vocab_size),
            attention=heads,
            moe=moe,
            ssm=ssm,
            frontend=frontend,
            layer_pattern=pattern,
            mtp_depth=min(1, self.mtp_depth),
            shared_attn_every=(2 if self.shared_attn_every else 0),
            dtype="float32",
        )

    def _reduced_pattern(self, n_layers: int) -> Tuple[str, ...]:
        full = self.pattern()
        if not full:
            return ()
        kinds: list[str] = []
        for k in full:
            if k not in kinds:
                kinds.append(k)
        out = tuple(kinds[i % len(kinds)] for i in range(max(n_layers, len(kinds))))
        return out[: max(n_layers, len(kinds))]


# ---------------------------------------------------------------------------
# Registry entry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelPlan:
    """Logical parallelism factors (workers × fsdp × tensor devices)."""

    workers: int
    fsdp: int
    tensor: int

    @property
    def num_devices(self) -> int:
        return self.workers * self.fsdp * self.tensor

    def scaled_to(self, n_devices: int) -> "ParallelPlan":
        base = self.fsdp * self.tensor
        if n_devices % base:
            raise ValueError(f"{n_devices} devices do not divide into fsdp*tensor={base}")
        return ParallelPlan(n_devices // base, self.fsdp, self.tensor)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    plans: dict
    long_context_policy: str = "native"  # native | swa_variant | skip
    swa_variant_window: int = 4096
    train_microbatch: Optional[int] = None

    @property
    def name(self) -> str:
        return self.model.name

    def plan_for(self, shape_name: str, n_devices: int) -> ParallelPlan:
        plan = self.plans.get(shape_name, self.plans["default"])
        return plan.scaled_to(n_devices)

    def supports(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            return self.long_context_policy != "skip"
        return True


# ---------------------------------------------------------------------------
# Algorithm / training config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlgoConfig:
    """Distributed-optimization algorithm selection (the paper's subject).
    ``packed`` (the default) runs the boundary on the packed plane;
    ``packed=False`` runs the per-leaf oracle (see
    ``repro_torch.core.strategy``). ``offload`` keeps the
    optimizer state and the anchor-shaped planes in (pinned) host memory
    between boundaries, streamed in ``offload_chunk_mb`` chunks
    (``repro_torch.parallel.offload``)."""

    name: str = "overlap_local_sgd"
    # overlap_local_sgd | local_sgd | sync_sgd | easgd | cocod | powersgd
    # | delayed_avg (DaSGD) | sparse_anchor (LOSCAR)
    # | gossip_pushsum / gossip_full / gossip_ring / gossip_exp (SGP)
    tau: int = 2  # local updates per round
    alpha: float = 0.6  # pullback strength (paper: 0.6 for tau>=2, 0.5 for tau=1)
    anchor_beta: float = 0.7  # anchor momentum (paper §4)
    easgd_beta: float = 0.9
    powersgd_rank: int = 2
    delay_steps: int = 1
    sparse_k: float = 1.0
    topology: str = "full"
    sync_router_stats: bool = True
    packed: bool = True  # round-boundary math on the packed parameter plane
    packed_clip: bool = False  # per-bucket (not per-leaf) order for the clip norm
    offload: bool = False
    offload_chunk_mb: float = 64.0


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd | adamw
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-4
    warmup_steps: int = 0
    decay_steps: Tuple[int, ...] = ()
    decay_factor: float = 0.1
    grad_clip: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
