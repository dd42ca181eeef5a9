"""Deprecated location (counterpart of ``repro.core.adaptive``): the
adaptive-τ machinery lives in :mod:`repro_torch.control`. The legacy names
are served from there with a :class:`DeprecationWarning`."""
from __future__ import annotations

import warnings

_MOVED = {
    "AdaptiveTau": "repro_torch.control",
    "TauScheduledTrainer": "repro_torch.control",
    "consensus_drift": "repro_torch.control",
}

__all__ = sorted(_MOVED)


def __getattr__(name: str):
    if name in _MOVED:
        warnings.warn(
            f"repro_torch.core.adaptive.{name} moved to {_MOVED[name]}.{name}; "
            "repro_torch.core.adaptive is a deprecated alias and will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        import repro_torch.control as _control

        return getattr(_control, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_MOVED))
