"""Mistral-Large-Instruct-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    attention=AttentionConfig(
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
    ),
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=2, fsdp=8, tensor=16)},
        train_microbatch=8,
        long_context_policy="swa_variant",
    )
)
