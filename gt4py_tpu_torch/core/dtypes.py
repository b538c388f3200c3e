"""numpy <-> torch dtype mapping.

The language layers (parser, analysis, passes) speak numpy dtypes, as in
``gt4py_tpu``; tensors carry torch dtypes.  This module is the one place
that translates between them.
"""

from __future__ import annotations

import numpy as np
import torch

from gt4py_tpu_torch.core.definitions import BFLOAT16

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    BFLOAT16: torch.bfloat16,
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


def _f64_to_f16(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 rounded once, to nearest even, as numpy's
    ``astype`` and the card's ``__double2half`` round.  (``.to(float16)``
    rounds a double through float32: twice.)  Rounded to odd into float32
    first -- truncate, then set the last bit when inexact -- a float32
    keeps the two extra bits that make the second rounding exact."""
    x32 = t.to(torch.float32)
    back = x32.to(torch.float64)
    inexact = (back != t) & torch.isfinite(t)
    away = inexact & (back.abs() > t.abs())
    x32 = torch.where(away, torch.nextafter(x32, torch.zeros_like(x32)), x32)
    x32 = torch.where(inexact, (x32.view(torch.int32) | 1).view(torch.float32), x32)
    return x32.to(torch.float16)


def cast(t: torch.Tensor, dt) -> torch.Tensor:
    """``t`` converted to ``dt`` (numpy or torch dtype) as numpy converts:
    float64 -> float16 rounds once.  float64 -> bfloat16 rounds through
    float32, as ``.to(torch.bfloat16)`` does and as the JAX package's
    oracle (ml_dtypes) does: the two agree on every non-NaN value."""
    tdt = to_torch(dt)
    if t.dtype == tdt:
        return t
    if tdt == torch.float16 and t.dtype == torch.float64:
        return _f64_to_f16(t)
    return t.to(tdt)


def scalar_value(value, dt):
    """``value`` (a Python or numpy scalar, or a one-element tensor)
    rounded to the numpy dtype ``dt``: the value a scalar argument or a
    literal of that dtype holds, as a numpy scalar (for bfloat16, which
    numpy lacks, a Python float)."""
    if isinstance(value, torch.Tensor):
        value = value.item()
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return cast(torch.tensor(float(value), dtype=torch.float64), BFLOAT16).item()
    return np.asarray(value, dtype=dt)[()]


def make_scalar(value, dt):
    """A scalar of the numpy dtype ``dt``: a numpy scalar, or for
    bfloat16, which numpy lacks, a 0-d CPU tensor (torch lets a 0-d CPU
    tensor join an operation on any device)."""
    dt = np.dtype(dt)
    if dt == BFLOAT16:
        return torch.tensor(scalar_value(value, dt), dtype=torch.bfloat16)
    return dt.type(value)
