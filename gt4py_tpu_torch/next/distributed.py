"""Distributed execution for the field-view DSL.

Counterpart of ``gt4py_tpu.next.distributed``.  There a ``next.Field``'s
data is a jax array and distribution is sharding: field operators staged
under ``jax.jit`` run SPMD, XLA inserting the halo collectives for the
domain shifts.  Here each rank of a ``parallel.CartesianMesh`` holds its
block of a field in a ``ShardedField`` (the global domain, the rank's
block of the data, its placement), and a field operator or scan called on
``ShardedField``s gives the oracle's result on the global domain: each
rank runs the operator on its block grown by the operator's halo
(``operator_halo``, exchanged over open edges, not beyond the global
domain), keeps the points of its block, and the result's domain is the
union of the ranks' parts (the shifts shrink it at the global edges).
The vertical dimension stays on each rank (scans need the whole column).

Usage::

    from gt4py_tpu_torch.parallel import CartesianMesh
    from gt4py_tpu_torch.next import distributed as nxd

    cmesh = CartesianMesh((2, 2))
    f = nxd.distribute(f, cmesh, {I: "x", J: "y"})
    out = lap(f)            # every rank computes its part
    nxd.gather(out)         # numpy-backed global Field, on every rank

Connectivity tables stay replicated (``replicate``); an operator that
reads a sharded dimension through one is refused (``operator_halo``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .common import Connectivity, Dimension, DimensionKind, Domain, Field, UnitRange


class Placement:
    """Where a field's data lives on a mesh: ``dim_map`` (dimension ->
    mesh axis) of the split dimensions; none for a replicated value."""

    def __init__(self, cmesh, dim_map: Dict[Dimension, str]):
        self.cmesh = cmesh
        self.dim_map = dict(dim_map)

    @property
    def is_fully_replicated(self) -> bool:
        return not self.dim_map

    def __repr__(self):
        spec = {d.value: ax for d, ax in self.dim_map.items()}
        return f"Placement({spec}, {self.cmesh})"


class ShardedField(Field):
    """A Field whose ``domain`` is global and whose ``data`` is this rank's
    block: ``block_index`` (``(start, stop)`` per axis, in the global
    data) places it.  ``asnumpy()`` gathers (a collective)."""

    def __init__(self, domain: Domain, data, placement: Placement, block_index):
        super().__init__(domain, data)
        self.placement = placement
        self.block_index = tuple(tuple(int(x) for x in ab) for ab in block_index)

    @property
    def global_shape(self) -> Tuple[int, ...]:
        return tuple(len(r) for r in self.domain.ranges)

    @property
    def local(self) -> Field:
        """This rank's block as a Field over its part of the domain."""
        return Field(Domain(self.dims, tuple(
            UnitRange(r.start + a, r.start + b)
            for r, (a, b) in zip(self.domain.ranges, self.block_index))), self.data)

    def asnumpy(self) -> np.ndarray:
        return gather(self).asnumpy()

    def __repr__(self):
        return f"ShardedField<{super().__repr__()}, block {self.block_index}>"


def _cmesh(mesh):
    """A ``parallel.CartesianMesh`` (or a ``Placement``'s)."""
    return getattr(mesh, "cmesh", mesh)


def infer_dim_map(field: Field, mesh) -> Dict[Dimension, str]:
    """Default dimension -> mesh-axis mapping: horizontal field dims are
    assigned to mesh axes in order; vertical/local dims stay on each rank."""
    axes = list(_cmesh(mesh).AXES)
    out: Dict[Dimension, str] = {}
    for d in field.dims:
        if d.kind == DimensionKind.HORIZONTAL and axes:
            out[d] = axes.pop(0)
    return out


def field_sharding(field: Field, mesh, dim_map: Optional[Dict[Dimension, str]] = None
                   ) -> Placement:
    """The placement of ``field`` with the ``dim_map`` dims split; raises
    ``ValueError`` for an unknown dimension or mesh axis, a vertical
    dimension and an uneven split."""
    cmesh = _cmesh(mesh)
    if dim_map is None:
        dim_map = infer_dim_map(field, cmesh)
    for d, ax in dim_map.items():
        if d not in field.dims:
            raise ValueError(f"dim_map names {d.value}, not a field dimension")
        if ax not in cmesh.AXES:
            raise ValueError(f"dim_map maps {d.value} to unknown mesh axis {ax!r}")
        if d.kind == DimensionKind.VERTICAL:
            raise ValueError(
                f"refusing to shard vertical dimension {d.value}: serial-K "
                "scans need the full column on each rank (keep K local)")
        n = cmesh.axis_size(ax)
        if len(field.domain[d]) % n:
            raise ValueError(
                f"dimension {d.value} (size {len(field.domain[d])}) does not "
                f"divide evenly over mesh axis {ax!r} ({n} ranks)")
    return Placement(cmesh, dim_map)


def _block_index(shape, dims, placement: Placement):
    coords = dict(zip(placement.cmesh.AXES, placement.cmesh.coords()))
    index = []
    for d, n in zip(dims, shape):
        ax = placement.dim_map.get(d)
        if ax is None:
            index.append((0, n))
            continue
        b = n // placement.cmesh.axis_size(ax)
        index.append((coords[ax] * b, (coords[ax] + 1) * b))
    return tuple(index)


def _to_device(data, device):
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.asarray(data))
    return t.to(device)


def distribute(field: Field, mesh, dim_map: Optional[Dict[Dimension, str]] = None
               ) -> ShardedField:
    """This rank's block of ``field`` (the same global values on every
    rank): the global view, with the domain unchanged."""
    placement = field_sharding(field, mesh, dim_map)
    index = _block_index(field.data.shape, field.dims, placement)
    block = field.data[tuple(slice(a, b) for a, b in index)]
    block = _to_device(block, placement.cmesh.device).contiguous()
    return ShardedField(field.domain, block, placement, index)


def replicate(value, mesh):
    """A Field (or a Connectivity's table) whole on every rank, on the
    mesh's device: the placement for neighbour tables and boundary
    masks."""
    cmesh = _cmesh(mesh)
    if isinstance(value, Connectivity):
        out = Connectivity(_to_device(value.table, cmesh.device), source=value.source,
                           codomain=value.codomain, local_dim=value.local_dim,
                           skip_value=value.skip_value)
    else:
        out = Field(value.domain, _to_device(value.data, cmesh.device))
    out.placement = Placement(cmesh, {})
    return out


def sharding_of(field) -> Optional[Placement]:
    """The placement of ``field`` (None for a field never placed)."""
    return getattr(field, "placement", None)


def operator_halo(op, dims) -> Dict[Dimension, int]:
    """Halo width the operator needs per dimension, from the typed IR's
    extent analysis (``extents.operator_extents``): the widest read
    offset over all parameters.  Data-dependent reads (variable offsets,
    remaps) along a sharded dim are rejected."""
    from .extents import FULL, operator_extents

    ext = operator_extents(op)
    halos: Dict[Dimension, int] = {}
    for d in dims:
        h = 0
        for dmaps in ext.values():
            e = dmaps.get(d, (0, 0))
            if e is FULL:
                raise ValueError(
                    f"operator '{op.__name__}' reads {d.value} at "
                    "data-dependent offsets; cannot shard that dimension")
            h = max(h, -e[0], e[1])
        halos[d] = h
    return halos


def _exchange(block: torch.Tensor, dims, placement: Placement, halos, periodic, boundary):
    """``block`` grown by ``halos`` (per split dimension) with the halos
    swapped with the neighbours."""
    from gt4py_tpu_torch.parallel.halo import HaloExchange, _pad

    sdims = [d for d in dims if d in placement.dim_map]
    if not sdims:
        return block
    if len(sdims) > 2:
        raise ValueError("shard one or two dimensions")
    d0 = sdims[0]
    d1 = sdims[1] if len(sdims) > 1 else d0
    hpair = (halos[d0], halos[d1] if len(sdims) > 1 else 0)
    spatial = (dims.index(d0), dims.index(d1))
    grown = _pad(block, hpair, spatial)
    per = (periodic, periodic) if isinstance(periodic, bool) else tuple(periodic)
    HaloExchange([grown], hpair, placement.cmesh,
                 axes=(placement.dim_map[d0], placement.dim_map[d1]), spatial_axes=spatial,
                 periodic=per, boundary=boundary).run()
    return grown


def _gather_ranges(cmesh, ranges):
    if not cmesh.distributed:
        return [ranges]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, ranges, group=cmesh.group)
    return out


def call_operator(op, args, kwargs):
    """A field operator or scan called on ``ShardedField``s (see the module
    docstring): this rank's part of the global result, as a
    ``ShardedField`` (a tuple of them for a tuple result)."""
    sharded = [a for a in list(args) + list(kwargs.values()) if isinstance(a, ShardedField)]
    placement = sharded[0].placement
    for a in sharded[1:]:
        if a.placement.cmesh is not placement.cmesh or a.placement.dim_map != placement.dim_map:
            raise ValueError("the ShardedFields of one call share their mesh and placement")
    sdims = list(placement.dim_map)
    halos = operator_halo(op, sdims)

    def local(a):
        if not isinstance(a, ShardedField):
            return a
        grown = _exchange(a.data, list(a.dims), placement, halos, False, "zero")
        ranges, idx = [], []
        for ax, (d, r, (b0, b1)) in enumerate(zip(a.dims, a.domain.ranges, a.block_index)):
            h = halos.get(d, 0) if d in placement.dim_map else 0
            lo, hi = max(r.start, r.start + b0 - h), min(r.stop, r.start + b1 + h)
            ranges.append(UnitRange(lo, hi))
            start = lo - (r.start + b0 - h)
            idx.append(slice(start, start + hi - lo))
        return Field(Domain(a.dims, tuple(ranges)), grown[tuple(idx)])

    own = sharded[0]
    owned = {d: (r.start + b0, r.start + b1) for d, r, (b0, b1)
             in zip(own.dims, own.domain.ranges, own.block_index) if d in placement.dim_map}
    result = op(*[local(a) for a in args], **{k: local(v) for k, v in kwargs.items()})

    def shard(o):
        ranges = []
        for d, r in zip(o.dims, o.domain.ranges):
            lo, hi = owned.get(d, (r.start, r.stop))
            lo, hi = max(lo, r.start), min(hi, r.stop)
            ranges.append(UnitRange(lo, max(lo, hi)))
        mine = o.restrict(Domain(o.dims, tuple(ranges)))
        pieces = _gather_ranges(placement.cmesh, [(x.start, x.stop) for x in ranges])
        glob = [UnitRange(min(p[ax][0] for p in pieces if p[ax][1] > p[ax][0]),
                          max(p[ax][1] for p in pieces if p[ax][1] > p[ax][0]))
                for ax in range(len(ranges))]
        index = [(x.start - g.start, x.stop - g.start) for x, g in zip(ranges, glob)]
        return ShardedField(Domain(o.dims, tuple(glob)), mine.data, placement, index)

    if isinstance(result, tuple):
        return tuple(shard(o) for o in result)
    return shard(result)


def shard_map_operator(op, mesh, dim_map: Optional[Dict[Dimension, str]] = None, *,
                       periodic=True, boundary: str = "zero"):
    """Explicit-halo-exchange execution of a field operator over the mesh
    (cartesian analog: ``parallel.shard_map_stencil``).

    Halo widths come from the operator's own extent analysis.  Each rank
    pads its block, fills the pad from its neighbours (rings when
    ``periodic``, else ``boundary`` = "zero"/"clamp" at the open edges),
    runs the operator on the halo-extended local Field, and keeps the
    interior, returned as a ``ShardedField`` over the arguments' global
    domain.  The field arguments (``ShardedField``s, or global Fields that
    every rank passes alike) share dims and domain; the operator returns
    field(s) over those dims.  Scalars pass through as keywords.
    """
    cmesh = _cmesh(mesh)

    def step(*fields, **scalars):
        fields = [f if isinstance(f, ShardedField) else distribute(f, cmesh, dim_map)
                  for f in fields]
        f0 = fields[0]
        for f in fields[1:]:
            if f.dims != f0.dims or f.domain.ranges != f0.domain.ranges:
                raise ValueError("shard_map_operator requires all field arguments to "
                                 "share dims and domain")
        placement = f0.placement
        sdims = list(placement.dim_map)
        if not 1 <= len(sdims) <= 2:
            raise ValueError("shard one or two dimensions")
        halos = operator_halo(op, sdims)
        dims = list(f0.dims)
        local_fields = []
        for f in fields:
            grown = _exchange(f.data, dims, placement, halos, periodic, boundary)
            ranges = tuple(UnitRange(-halos[d], grown.shape[i] - halos[d]) if d in halos
                           else UnitRange(0, grown.shape[i]) for i, d in enumerate(dims))
            local_fields.append(Field(Domain(f0.dims, ranges), grown))
        out = op(*local_fields, **scalars)
        interior = Domain(tuple(sdims), tuple(
            UnitRange(0, f0.data.shape[dims.index(d)]) for d in sdims))

        def crop(o):
            if o.dims != f0.dims:
                raise ValueError(
                    "shard_map_operator expects the operator to return fields over "
                    f"{[d.value for d in f0.dims]}, got {[d.value for d in o.dims]}")
            return ShardedField(f0.domain, o.restrict(interior).data, placement, f0.block_index)

        if isinstance(out, tuple):
            return tuple(crop(o) for o in out)
        return crop(out)

    return step


def gather(field: Field) -> Field:
    """The whole field on every rank as a numpy-backed Field (oracle
    compatible); a collective for a ``ShardedField``."""
    if not isinstance(field, ShardedField):
        return Field(field.domain, field.asnumpy())
    from gt4py_tpu_torch.parallel.distributed import _gather_blocks, _host

    data = _gather_blocks(field.placement.cmesh, _host(field.data), field.block_index,
                          field.global_shape)
    return Field(field.domain, data)
