"""Qwen2-VL-7B [arXiv:2409.12191] — the Qwen2-7B backbone with M-RoPE and a
vision frontend: the model takes precomputed ViT patch embeddings (1280
wide, 1024 an image) through a learned two-layer GELU projector and
prepends them to the text."""
from repro_torch.config import ArchConfig, AttentionConfig, FrontendConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attention=AttentionConfig(
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        rope="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # (t, h, w) bands over head_dim/2 = 64
    ),
    frontend=FrontendConfig(kind="vision", embed_dim=1280, tokens_per_item=1024),
    norm_eps=1e-6,
    source="arXiv:2409.12191",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=16, fsdp=1, tensor=16)},
        train_microbatch=4,
        long_context_policy="swa_variant",
    )
)
