"""Parameter construction (counterpart of ``repro.models.params``).

``Builder`` creates nested dicts of tensors with the reference's init rules
(``params.py:63-96``): ``fan_in`` draws N(0, 1/fan_in) with fan_in the first
dim of a matrix (the middle dim of an expert stack), ``normal`` draws
N(0, 0.02²), plus ``zeros``/``ones``. Draws are float32 from an
explicit ``torch.Generator`` and cast to the parameter dtype. The values
differ from ``jax.random``'s; parity tests take JAX's weights through
:func:`repro_torch.interop.params_from_numpy` instead.

Weight matrices keep the reference's ``(d_in, d_out)`` layout and are
applied as ``x @ w``. A builder made with ``lead=(n,)`` creates every leaf
with a leading layer axis of n (a stacked segment), drawing each layer's
values independently while taking fan_in from the per-layer shape.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch


class Builder:
    def __init__(
        self,
        generator: torch.Generator,
        dtype: torch.dtype = torch.float32,
        device="cpu",
        lead: Tuple[int, ...] = (),
    ):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.lead = tuple(lead)
        self.params: dict = {}
        self._path: list = []

    @contextlib.contextmanager
    def scope(self, name: str):
        self._path.append(str(name))
        try:
            yield self
        finally:
            self._path.pop()

    def _insert(self, name: str, value):
        p = self.params
        for part in self._path:
            p = p.setdefault(part, {})
        if name in p:
            raise ValueError(f"duplicate param {'/'.join(self._path + [name])}")
        p[name] = value

    def _normal(self, shape, std: float, dtype) -> torch.Tensor:
        v = torch.empty(self.lead + tuple(shape), dtype=torch.float32, device=self.device)
        v.normal_(0.0, std, generator=self.generator)
        return v.to(dtype)

    def param(
        self,
        name: str,
        shape: Sequence[int],
        init: str = "fan_in",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        dtype = dtype or self.dtype
        full = self.lead + tuple(shape)
        if init == "zeros":
            v = torch.zeros(full, dtype=dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(full, dtype=dtype, device=self.device)
        elif init == "normal":
            v = self._normal(shape, 0.02 if scale is None else scale, dtype)
        elif init == "fan_in":
            fan_in = shape[0] if len(shape) >= 2 else max(math.prod(shape), 1)
            if len(shape) == 3:  # (experts, d_in, d_out)
                fan_in = shape[1]
            s = (1.0 / math.sqrt(fan_in)) if scale is None else scale / math.sqrt(fan_in)
            v = self._normal(shape, s, dtype)
        else:
            raise ValueError(init)
        self._insert(name, v)
        return v


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return params.numel()
