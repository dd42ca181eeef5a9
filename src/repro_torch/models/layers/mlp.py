"""SwiGLU feed-forward (counterpart of ``repro.models.layers.mlp.swiglu``
with ``act="silu"``, the only activation the ported archs use)."""
from __future__ import annotations

import torch.nn.functional as F


def init_swiglu(b, name: str, d_model: int, d_ff: int):
    with b.scope(name):
        b.param("wi_gate", (d_model, d_ff))
        b.param("wi_up", (d_model, d_ff))
        b.param("wo", (d_ff, d_model))


def swiglu(params, x):
    return (F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])) @ params["wo"]
