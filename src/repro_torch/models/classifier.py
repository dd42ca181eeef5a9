"""Small MLP classifier, the paper's CIFAR-10/ResNet-18 stand-in (counterpart
of ``repro.models.classifier``).

Parameters are nested dicts of ``(d_in, d_out)`` matrices and biases, as in
the reference. :func:`mlp_apply` and :func:`mlp_loss` also take
worker-stacked parameters (leaves ``(m, ...)``, views of the training plane)
with batches ``(m, b, ...)``: the m workers then run as one batched matmul
(``torch.matmul`` on 3-D operands is ``bmm``), the vmap of the reference
written out.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import Builder


def init_mlp(generator: torch.Generator, dim: int, num_classes: int, hidden: Tuple[int, ...] = (128, 64),
             dtype: torch.dtype = torch.float32, device="cpu") -> dict:
    b = Builder(generator, dtype, device=device)
    last = dim
    for i, h in enumerate(hidden):
        b.param(f"w{i}", (last, h))
        b.param(f"b{i}", (h,), init="zeros")
        last = h
    b.param("w_out", (last, num_classes))
    b.param("b_out", (num_classes,), init="zeros")
    return b.params


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as ``jnp`` promotes (f32 data times
    bf16 weights runs in f32); PyTorch's matmul wants one dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (b, dim) with plain params, or (m, b, dim) with stacked params."""
    h = x
    i = 0
    while f"w{i}" in params:
        h = torch.tanh(_matmul(h, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(-2))
        i += 1
    return _matmul(h, params["w_out"]) + params["b_out"].unsqueeze(-2)


def mlp_loss(params: dict, batch) -> Tuple[torch.Tensor, dict]:
    """batch: (x (m, b, dim), y (m, b)) → per-worker mean cross-entropy (m,)
    and metrics (m,)."""
    x, y = batch
    logits = mlp_apply(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long().unsqueeze(-1)).squeeze(-1)
    loss = torch.mean(lse - gold, dim=-1)
    acc = torch.mean((torch.argmax(logits, dim=-1) == y).float(), dim=-1)
    return loss, dict(loss=loss, acc=acc)


@torch.no_grad()
def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor, batch: int = 4096) -> float:
    """Share of ``x`` (n, dim) that the plain ``params`` classify as ``y``
    (one host read at the end)."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], batch):
        logits = mlp_apply(params, x[i : i + batch])
        correct += torch.sum(torch.argmax(logits, dim=-1) == y[i : i + batch])
    return int(correct) / x.shape[0]
