"""Parameter transfer from the JAX reference's layout.

:func:`params_from_numpy` takes the tree ``repro.models.transformer.init_model``
returns, after the caller has turned every leaf into a numpy array (nested
dicts; stacked ``seg{i}`` leaves keep their leading layer axis), and gives
the port's parameters: the same nesting and the same ``(d_in, d_out)``
matrices, so the copy is leaf for leaf. This module imports no JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays → nested dicts of tensors on ``device``,
    cast to ``dtype`` when given (else the arrays' own dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = _tensor(tree)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()
