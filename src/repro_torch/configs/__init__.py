"""Ported architecture configs. Importing this package registers them."""
from repro_torch.configs import qwen2_7b  # noqa: F401

ASSIGNED = ["qwen2-7b"]
