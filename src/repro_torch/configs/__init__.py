"""Ported architecture configs. Importing this package registers them."""
from repro_torch.configs import qwen2_7b, rwkv6_7b, zamba2_1_2b  # noqa: F401

ASSIGNED = ["qwen2-7b", "rwkv6-7b", "zamba2-1.2b"]
