"""Feed-forward layers (counterpart of ``repro.models.layers.mlp``): SwiGLU
(the llama family) and the plain GELU MLP with biases (musicgen). The GELU
is the tanh form, ``jax.nn.gelu``'s default."""
from __future__ import annotations

import torch.nn.functional as F


def init_swiglu(b, name: str, d_model: int, d_ff: int):
    with b.scope(name):
        b.param("wi_gate", (d_model, d_ff))
        b.param("wi_up", (d_model, d_ff))
        b.param("wo", (d_ff, d_model))


def gelu(x):
    return F.gelu(x, approximate="tanh")


def swiglu(params, x, act: str = "silu"):
    """The gate's activation is SiLU for ``act="silu"`` and GELU otherwise, as the reference's."""
    g = x @ params["wi_gate"]
    a = F.silu(g) if act == "silu" else gelu(g)
    return (a * (x @ params["wi_up"])) @ params["wo"]


def init_gelu_mlp(b, name: str, d_model: int, d_ff: int):
    with b.scope(name):
        b.param("wi", (d_model, d_ff))
        b.param("bi", (d_ff,), init="zeros")
        b.param("wo", (d_ff, d_model))
        b.param("bo", (d_model,), init="zeros")


def gelu_mlp(params, x):
    h = x @ params["wi"] + params["bi"]
    return gelu(h) @ params["wo"] + params["bo"]
