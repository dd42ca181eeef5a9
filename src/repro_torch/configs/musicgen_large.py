"""MusicGen-large [arXiv:2306.05284] — a decoder-only transformer over
EnCodec tokens: four codebooks (the delay pattern applied by the data
pipeline), their embeddings summed into one stream and one head a codebook;
GELU MLPs with biases, multi-head attention. As in the reference, RoPE
stands in for the released model's sinusoidal embeddings."""
from repro_torch.config import ArchConfig, AttentionConfig, FrontendConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        rope_theta=10000.0,
    ),
    act="gelu",
    frontend=FrontendConfig(kind="audio", embed_dim=2048, tokens_per_item=1500, num_codebooks=4),
    source="arXiv:2306.05284",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=16, fsdp=1, tensor=16)},
        train_microbatch=8,
        long_context_policy="swa_variant",
    )
)
