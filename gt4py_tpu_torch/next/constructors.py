"""Field/connectivity constructors.

The counterpart of ``gt4py_tpu.next.constructors`` (reference:
src/gt4py/next/constructors.py:394-690, empty/zeros/ones/full/as_field/
as_connectivity with allocator/device arguments).  Every constructor takes
``device=`` (default ``config.DEFAULT_DEVICE``, the card; a device that is
not there raises, see ``config.resolve_device``); ``allocator="numpy"``
builds a numpy-backed field instead, which runs on the embedded oracle.

Layout: a field the constructors allocate, or copy from a numpy array,
keeps its vertical dimensions outermost in memory and its last horizontal
dimension contiguous -- for (I, J, K) the storage is (K, I, J), the
layout the CUDA kernels read coalesced (threads run along J).  The field's
logical dims stay as declared: ``data`` is a permuted view.  A torch
tensor given to ``as_field`` is used as it is, sharing its memory.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.core import dtypes

from .common import (
    Connectivity,
    Dimension,
    DimensionKind,
    Domain,
    Field,
    UnitRange,
    domain_like,
)

DomainLike = Union[Domain, dict, Sequence[Tuple[Dimension, int]]]

_as_domain = domain_like


def _storage_order(dims: Sequence[Dimension]) -> list:
    """Axis order of the storage: vertical dims first, then the rest in
    their declared order."""
    n = len(dims)
    vert = [a for a in range(n) if dims[a].kind == DimensionKind.VERTICAL]
    return vert + [a for a in range(n) if a not in vert]


def _alloc(fill, dims, shape, dtype, device) -> torch.Tensor:
    """A tensor of logical ``shape`` over storage in ``_storage_order``."""
    order = _storage_order(dims)
    storage = fill(tuple(shape[a] for a in order), dtype=dtypes.to_torch(dtype),
                   device=config.resolve_device(device))
    return storage.permute(*np.argsort(order).tolist())


def _make(fill, domain, dtype, device, allocator) -> Field:
    dom = _as_domain(domain)
    if allocator == "numpy":
        return Field(dom, fill(dom.shape, dtype=dtype))
    return Field(dom, _alloc(getattr(torch, fill.__name__), dom.dims, dom.shape, dtype, device))


def empty(domain: DomainLike, dtype=np.float64, *, device=None, allocator=None) -> Field:
    return _make(np.empty, domain, dtype, device, allocator)


def zeros(domain: DomainLike, dtype=np.float64, *, device=None, allocator=None) -> Field:
    return _make(np.zeros, domain, dtype, device, allocator)


def ones(domain: DomainLike, dtype=np.float64, *, device=None, allocator=None) -> Field:
    return _make(np.ones, domain, dtype, device, allocator)


def full(domain: DomainLike, fill_value, dtype=np.float64, *, device=None,
         allocator=None) -> Field:
    dom = _as_domain(domain)
    if allocator == "numpy":
        return Field(dom, np.full(dom.shape, fill_value, dtype=dtype))
    data = _alloc(torch.empty, dom.dims, dom.shape, dtype, device)
    data.fill_(fill_value)
    return Field(dom, data)


def _from_numpy(dims, array: np.ndarray, device) -> torch.Tensor:
    """A copy of ``array`` on ``device`` in the constructors' layout."""
    array = np.asarray(array)
    if len(dims) != array.ndim:
        return torch.as_tensor(array, device=config.resolve_device(device))
    out = _alloc(torch.empty, dims, array.shape, array.dtype, device)
    out.copy_(torch.from_numpy(np.ascontiguousarray(array)))
    return out


def as_field(dims_or_domain, data, *, origin: Optional[dict] = None, device=None,
             allocator=None) -> Field:
    """Wrap an array as a Field.

    ``as_field((I, J), array)`` gives ranges starting at 0 (or at
    ``-origin[dim]`` when origins are passed, mirroring the reference's
    origin semantics).  A torch tensor is used as it is (moved only when
    ``device`` names another device); anything else is copied into a
    tensor on ``device`` in the constructors' layout.  ``allocator=
    "numpy"`` keeps numpy data: the field then runs on the embedded
    oracle.
    """
    dims = tuple(dims_or_domain.dims) if isinstance(dims_or_domain, Domain) \
        else tuple(dims_or_domain)
    if allocator == "numpy":
        data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    elif isinstance(data, torch.Tensor):
        if device is not None and torch.device(device) != data.device:
            data = data.to(device)
    else:
        data = _from_numpy(dims, data, device)
    if isinstance(dims_or_domain, Domain):
        return Field(dims_or_domain, data)
    origin = origin or {}
    ranges = []
    for d, size in zip(dims, data.shape):
        o = int(origin.get(d, 0))
        ranges.append(UnitRange(-o, size - o))
    return Field(Domain(dims, tuple(ranges)), data)


def as_connectivity(
    table,
    *,
    source: Dimension,
    codomain: Dimension,
    local_dim: Optional[Dimension] = None,
    skip_value: Optional[int] = -1,
    device=None,
    allocator=None,
) -> Connectivity:
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    table = np.asarray(table, dtype=np.int32)
    if allocator != "numpy":
        table = torch.as_tensor(table, device=config.resolve_device(device))
    if local_dim is None:
        local_dim = Dimension(
            f"{source.value}2{codomain.value}", DimensionKind.LOCAL
        )
    return Connectivity(
        table=table,
        source=source,
        codomain=codomain,
        local_dim=local_dim,
        skip_value=skip_value,
    )
