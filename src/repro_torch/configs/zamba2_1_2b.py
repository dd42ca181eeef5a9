"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone with a weight-shared
attention block interleaved (every 7th position; the released model shares
one transformer block invoked periodically — the reference keeps the
shared-weights property and drops only the per-invocation LoRA deltas,
DESIGN.md)."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, ParallelPlan, SSMConfig, register

_PATTERN = tuple("shared_attn" if i % 7 == 6 else "mamba2" for i in range(38))

MODEL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        sliding_window=4096,  # keeps long contexts serveable; full attention within 4k
        rope_theta=10000.0,
    ),
    ssm=SSMConfig(kind="mamba2", state_dim=64, num_heads=64, head_dim=64, expand=2, conv_width=4, chunk_size=128),
    layer_pattern=_PATTERN,
    shared_attn_every=7,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=16, fsdp=1, tensor=16)},
        train_microbatch=8,
        long_context_policy="native",  # SSM state + windowed shared attention
    )
)
