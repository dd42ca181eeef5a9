"""Command-line launchers (``train``, ``serve``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


def cut(cfg, layers: Optional[int] = None, experts: Optional[int] = None):
    """``cfg`` cut to its first ``layers`` layers and ``experts`` routed
    experts (each left as it is when None): the published widths at a depth
    one card holds (``--full --layers N``)."""
    kw = {}
    if layers is not None:
        if not 1 <= layers <= cfg.num_layers:
            raise ValueError(f"--layers must be in [1, {cfg.num_layers}], got {layers}")
        kw.update(num_layers=layers, layer_pattern=cfg.pattern()[:layers])
    if experts is not None:
        if cfg.moe is None or not cfg.moe.top_k <= experts <= cfg.moe.num_experts:
            raise ValueError(f"experts needs a MoE config and top_k <= experts <= num_experts, got {experts}")
        kw.update(moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return dataclasses.replace(cfg, **kw) if kw else cfg
