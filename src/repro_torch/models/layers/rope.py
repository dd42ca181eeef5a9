"""Rotary position embeddings, rotate-half convention (Llama/Qwen); counterpart
of ``repro.models.layers.rope`` without M-RoPE (ROADMAP Queue 1 item 8).
Angles and the rotation are float32; the result is cast back."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def text_positions(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``."""
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq) + offset


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) f32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1 = x1.to(torch.float32)
    xf2 = x2.to(torch.float32)
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)
