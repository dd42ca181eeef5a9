"""RWKV-6 "Finch" 7B [arXiv:2404.05892] — attention-free; time-mix with
data-dependent decay + channel-mix. 64 heads × 64 head_dim."""
from repro_torch.config import ArchConfig, ModelConfig, ParallelPlan, SSMConfig, register

MODEL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=None,
    ssm=SSMConfig(kind="rwkv6", num_heads=64, head_dim=64, chunk_size=32),
    layer_pattern=("rwkv6",) * 32,
    source="arXiv:2404.05892",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={"default": ParallelPlan(workers=16, fsdp=1, tensor=16)},
        train_microbatch=4,
        long_context_policy="native",  # constant-size recurrent state
    )
)
