"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense-MoE
hybrid: every layer has a 128-expert top-2 MoE *in parallel with* a dense
residual FFN."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, MoEConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_ff=4864,
        dense_residual_ff=4864,
    ),
    layer_pattern=("moe",) * 35,
    source="hf:Snowflake/snowflake-arctic-base",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={
            # one local replica a pod in the reference's TPU plan (w=1); the
            # port stacks its workers on one card instead
            "default": ParallelPlan(workers=1, fsdp=16, tensor=16),
        },
        train_microbatch=16,
        long_context_policy="swa_variant",
    )
)
