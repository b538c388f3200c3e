"""numpy <-> torch dtype mapping.

The language layers (parser, analysis, passes) speak numpy dtypes, as in
``gt4py_tpu``; tensors carry torch dtypes.  This module is the one place
that translates between them.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def to_torch(dt) -> torch.dtype:
    """numpy dtype (or anything ``np.dtype`` accepts, or a torch dtype)
    -> torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except KeyError:
        raise TypeError(f"dtype {np.dtype(dt)} has no torch counterpart here") from None


def to_numpy(dt) -> np.dtype:
    """torch dtype (or a numpy dtype spec) -> numpy dtype."""
    if isinstance(dt, torch.dtype):
        try:
            return _TORCH_TO_NP[dt]
        except KeyError:
            raise TypeError(f"torch dtype {dt} has no numpy counterpart here") from None
    return np.dtype(dt)
