"""Live-worker membership for degraded round boundaries (counterpart of
``repro.fault.membership``).

A :class:`Membership` is the device-side face of the fault layer: a {0, 1}
liveness mask over the worker axis and the averaging weights renormalised
over the live workers, w_i = mask_i / Σ mask, both (m,) float32 tensors on
the plane's device. It rides in ``TrainState.membership`` and only the round
boundaries read it: a masked boundary pulls back and averages live rows, and
dead rows pass through. ``membership=None`` is the fully-live path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Membership(NamedTuple):
    """Live-worker mask and renormalised averaging weights, (m,) float32;
    the masked worker mean is Σ_i w_i·x_i. Liveness is ``weights > 0``."""

    mask: torch.Tensor
    weights: torch.Tensor

    @property
    def m(self) -> int:
        return int(self.mask.shape[0])

    def live_count(self) -> torch.Tensor:
        return torch.sum(self.mask)

    def is_full(self) -> bool:
        """Host-side check: is every worker live?"""
        return bool(self.mask.cpu().bool().all())


def full(m: int, device="cpu") -> Membership:
    """The fully-live membership over ``m`` workers."""
    mask = torch.ones((m,), dtype=torch.float32, device=device)
    return Membership(mask=mask, weights=mask / torch.full((), float(m), device=device))


def from_mask(mask, device="cpu") -> Membership:
    """A membership from a {0, 1} liveness mask (numpy or tensor), the
    weights renormalised over the live set. At least one worker must be live
    (an all-dead round has no boundary); the check reads the mask on the host."""
    mask = torch.as_tensor(np.asarray(mask, np.float32) if not isinstance(mask, torch.Tensor) else mask,
                           dtype=torch.float32, device=device)
    if mask.dim() != 1:
        raise ValueError(f"membership mask must be 1-D over workers, got shape {tuple(mask.shape)}")
    n_live = torch.sum(mask)
    if float(n_live) <= 0:
        raise ValueError("membership mask has no live workers")
    return Membership(mask=mask, weights=mask / n_live)
