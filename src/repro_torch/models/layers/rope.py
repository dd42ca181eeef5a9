"""Rotary position embeddings, rotate-half convention (Llama/Qwen), and
Qwen2-VL's M-RoPE (counterpart of ``repro.models.layers.rope``). Angles and
the rotation are float32; the result is cast back.

M-RoPE [arXiv:2409.12191] splits the head_dim/2 rotary frequencies into
(temporal, height, width) sections, each band rotating by its own position
stream; text tokens carry equal (t, h, w) positions, so M-RoPE is RoPE for
pure text."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def text_positions(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``."""
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq) + offset


def text_mrope_positions(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, 3, seq) int32: the text positions in each of the t, h and w streams."""
    p = text_positions(batch, seq, offset, device)
    return p[:, None, :].expand(batch, 3, seq)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) f32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, 3, S) int, each token's (t, h, w) -> cos/sin (B, S,
    head_dim/2) f32. Frequency j rotates by stream ``sec_id[j]``, the
    sections laid end to end (t's band first); the angle is the reference's
    product of the same f32 position and frequency."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim/2 = {half}")
    dev = positions.device
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=dev),
                                     torch.tensor(tuple(sections), device=dev))  # (half,)
    pos = positions.to(torch.float32)[:, sec_id].transpose(1, 2)  # (B, S, half): band j's stream
    ang = pos * rope_freqs(head_dim, theta, dev)
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
