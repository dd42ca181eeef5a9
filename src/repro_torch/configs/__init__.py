"""Ported architecture configs. Importing this package registers them."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    command_r_35b,
    deepseek_v3_671b,
    h2o_danube_1_8b,
    mistral_large_123b,
    musicgen_large,
    qwen2_7b,
    qwen2_vl_7b,
    rwkv6_7b,
    zamba2_1_2b,
)

ASSIGNED = ["qwen2-7b", "rwkv6-7b", "zamba2-1.2b", "h2o-danube-1.8b", "mistral-large-123b", "command-r-35b",
            "arctic-480b", "deepseek-v3-671b", "qwen2-vl-7b", "musicgen-large"]
