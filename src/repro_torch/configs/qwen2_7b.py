"""Qwen2-7B [arXiv:2407.10671] — dense, GQA (28H / 4 KV), QKV bias."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attention=AttentionConfig(
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    norm_eps=1e-6,
    source="arXiv:2407.10671",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={
            "default": ParallelPlan(workers=16, fsdp=1, tensor=16),
        },
        train_microbatch=4,
        long_context_policy="swa_variant",
    )
)
