"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed experts
top-8 (sigmoid router, normalized gates), first 3 layers dense, MTP module."""
from repro_torch.config import ArchConfig, AttentionConfig, ModelConfig, MoEConfig, ParallelPlan, register

MODEL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=18432,  # dense layers (first 3)
    vocab_size=129280,
    attention=AttentionConfig(
        kind="mla",
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,  # qk_nope + qk_rope
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10000.0,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_ff=2048,
        num_shared_experts=1,
        shared_expert_ff=2048,
        first_k_dense=3,
    ),
    layer_pattern=("attn",) * 3 + ("moe",) * 58,
    mtp_depth=1,
    source="arXiv:2412.19437",
)

ARCH = register(
    ArchConfig(
        model=MODEL,
        plans={
            # one replica needs a whole pod in the reference's TPU plan (w=1);
            # the port stacks its workers on one card instead
            "default": ParallelPlan(workers=1, fsdp=16, tensor=16),
        },
        train_microbatch=16,
        long_context_policy="swa_variant",
    )
)
