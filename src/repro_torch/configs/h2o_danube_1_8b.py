"""H2O-Danube-1.8B [arXiv:2401.16818] — llama/mistral mix with sliding-window
attention (the model card trains with mistral-style SWA)."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        sliding_window=4096,
        rope_theta=10000.0,
    ),
    source="arXiv:2401.16818",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=16, fsdp=1, tensor=16)},
        train_microbatch=8,
        long_context_policy="native",  # SWA is part of the architecture
    )
)
