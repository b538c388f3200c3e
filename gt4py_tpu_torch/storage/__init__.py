"""Storage: field allocation with origins (halos) over torch tensors.

Counterpart of ``gt4py_tpu.storage`` (reference API:
src/gt4py/storage/cartesian/interface.py:40-264,
``empty/zeros/ones/full/from_array`` with ``aligned_index``).  A
``FieldStorage`` holds a ``torch.Tensor`` on an explicit ``device`` in the
logical (I, J, K, *data_dims) layout; ``aligned_index`` is its origin,
the offset of the compute-domain start inside the buffer.  Stencil calls
update ``data`` in place.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.core import dtypes

__all__ = [
    "FieldStorage",
    "empty",
    "zeros",
    "ones",
    "full",
    "from_array",
]


class FieldStorage:
    """A field tensor + origin + axis names (``__gt_origin__`` /
    ``__gt_dims__`` metadata, as in ``gt4py_tpu.storage``)."""

    def __init__(self, data: torch.Tensor, origin: Tuple[int, ...], dims: Tuple[str, ...]):
        self.data = data
        self.origin = tuple(int(o) for o in origin)
        self.dims = tuple(dims)

    def __array__(self, dtype=None, copy=None):
        arr = self.data.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_numpy(self.data.dtype)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def __gt_origin__(self):
        return self.origin

    @property
    def __gt_dims__(self):
        return self.dims

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def __repr__(self):
        return (
            f"FieldStorage(shape={self.shape}, dtype={self.dtype}, "
            f"origin={self.origin}, dims={self.dims}, device={self.device})"
        )


def _default_dims(ndim_spatial: int, data_ndim: int) -> Tuple[str, ...]:
    spatial = ("I", "J", "K")[:ndim_spatial]
    return spatial + tuple(str(i) for i in range(data_ndim))


def _normalize(shape, aligned_index, dimensions, data_dims=()):
    shape = tuple(int(s) for s in shape)
    ndata = len(tuple(data_dims))
    nspatial = len(shape) - ndata
    if dimensions is None:
        dims = _default_dims(nspatial, ndata)
    else:
        dims = tuple(str(d) for d in dimensions)
        if len(dims) < len(shape):
            dims = dims + tuple(str(i) for i in range(len(shape) - len(dims)))
    if aligned_index is None:
        aligned_index = (0,) * nspatial
    return shape, tuple(int(i) for i in aligned_index), dims


def _device(device) -> torch.device:
    return torch.device(config.DEFAULT_DEVICE if device is None else device)


def empty(shape: Sequence[int], dtype=np.float64, *, device=None,
          aligned_index: Optional[Sequence[int]] = None,
          dimensions: Optional[Sequence[str]] = None,
          data_dims: Sequence[int] = ()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    t = torch.empty(shape, dtype=dtypes.to_torch(dtype), device=_device(device))
    return FieldStorage(t, origin, dims)


def zeros(shape, dtype=np.float64, *, device=None, aligned_index=None,
          dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    t = torch.zeros(shape, dtype=dtypes.to_torch(dtype), device=_device(device))
    return FieldStorage(t, origin, dims)


def ones(shape, dtype=np.float64, *, device=None, aligned_index=None,
         dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    t = torch.ones(shape, dtype=dtypes.to_torch(dtype), device=_device(device))
    return FieldStorage(t, origin, dims)


def full(shape, fill_value, dtype=np.float64, *, device=None, aligned_index=None,
         dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    t = torch.full(shape, fill_value, dtype=dtypes.to_torch(dtype), device=_device(device))
    return FieldStorage(t, origin, dims)


def from_array(data, dtype=None, *, device=None,
               aligned_index: Optional[Sequence[int]] = None,
               dimensions: Optional[Sequence[str]] = None,
               data_dims: Sequence[int] = ()) -> FieldStorage:
    """Copy ``data`` (numpy array, tensor or nested sequence) into a new
    field on ``device``."""
    if isinstance(data, torch.Tensor):
        t = data.detach().clone()
    else:
        t = torch.from_numpy(np.array(data, copy=True))
    if dtype is not None:
        t = t.to(dtypes.to_torch(dtype))
    t = t.to(_device(device)).contiguous()
    shape, origin, dims = _normalize(t.shape, aligned_index, dimensions, data_dims)
    return FieldStorage(t, origin, dims)
