"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — GQA, no biases,
parallel attn∥FFN blocks, LayerNorm, tied embeddings, logit_scale 0.0625."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    d_ff=22528,
    vocab_size=256000,
    attention=AttentionConfig(
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=8_000_000.0,
    ),
    use_parallel_block=True,
    tie_embeddings=True,
    logit_scale=0.0625,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=4, fsdp=4, tensor=16)},
        train_microbatch=8,
        long_context_policy="swa_variant",
    )
)
