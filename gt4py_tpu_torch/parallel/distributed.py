"""The global view: fields distributed over the rank mesh.

Counterpart of ``gt4py_tpu.parallel.distributed``.  There a field is a
global jax array sharded over the mesh and stencils run on the global
domain, XLA (GSPMD) inserting the halo collectives.  Here each rank holds
its block of the global buffer in a ``DistributedField`` (a
``FieldStorage`` of the block with the global shape, the block's global
index and the mesh), and a stencil called on ``DistributedField``s gives
the single-device result on the global domain: each rank computes the
part of the global compute domain that lies in its block, from its block
grown by the stencil's own halo (exchanged over open edges, nothing filled
beyond the global buffer), with horizontal regions and axis positions
resolved against the global domain (the backends' region frame).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import _stmt_reads, _stmt_writes
from gt4py_tpu_torch.cartesian.backend.cuda_backend import _ij
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import Extent
from gt4py_tpu_torch.storage import FieldStorage

from .halo import HaloExchange, _pad


class FieldSharding(NamedTuple):
    """Where a global array's blocks live: the mesh, and the tensor axes
    split over its "x" and "y" axes."""

    cmesh: object
    spatial_axes: Tuple[int, int] = (0, 1)


def _sharding(where) -> FieldSharding:
    return where if isinstance(where, FieldSharding) else FieldSharding(where)


def block_index(shape, sharding: FieldSharding, rank: Optional[int] = None):
    """The global index (one ``(start, stop)`` per axis) of a rank's block
    of an array of ``shape``.  Split axes must divide evenly."""
    cmesh = sharding.cmesh
    coords = cmesh.coords(rank)
    index = [(0, int(n)) for n in shape]
    for m, (a, n) in enumerate(zip(sharding.spatial_axes, cmesh.shape)):
        size = int(shape[a])
        if size % n:
            raise ValueError(f"axis {a} (size {size}) does not divide evenly over mesh axis "
                             f"{cmesh.AXES[m]!r} ({n} ranks)")
        b = size // n
        index[a] = (coords[m] * b, (coords[m] + 1) * b)
    return tuple(index)


class DistributedField(FieldStorage):
    """A ``FieldStorage`` of this rank's block of a global field.

    ``global_shape`` and ``index`` (the block's ``(start, stop)`` per
    axis) place the block; ``origin`` is the global buffer's origin.
    ``DistributedField(cmesh, data, origin)`` distributes the global
    array ``data`` (every rank passes the same values)."""

    def __init__(self, cmesh, data, origin, dims=("I", "J", "K"), *, spatial_axes=(0, 1)):
        block, index = _local_block(data, FieldSharding(cmesh, tuple(spatial_axes)))
        self._place(block, origin, dims, FieldSharding(cmesh, tuple(spatial_axes)),
                    tuple(np.shape(data)), index)

    def _place(self, block, origin, dims, sharding, global_shape, index):
        FieldStorage.__init__(self, block, origin, dims)
        self.sharding = sharding
        self.cmesh = sharding.cmesh
        self.global_shape = tuple(int(s) for s in global_shape)
        self.index = tuple(index)

    @classmethod
    def from_block(cls, block: torch.Tensor, like: "DistributedField") -> "DistributedField":
        """A new block at ``like``'s place."""
        out = cls.__new__(cls)
        out._place(block, like.origin, like.dims, like.sharding, like.global_shape, like.index)
        return out

    @classmethod
    def zeros(cls, cmesh, shape, dtype=np.float32, *, origin=None, spatial_axes=(0, 1)):
        sharding = FieldSharding(cmesh, tuple(spatial_axes))
        index = block_index(shape, sharding)
        block = torch.zeros([b - a for a, b in index], dtype=dtypes.to_torch(dtype),
                            device=cmesh.device)
        out = cls.__new__(cls)
        out._place(block, origin or (0,) * len(shape), _dims(len(shape)), sharding,
                   tuple(shape), index)
        return out

    @classmethod
    def from_array(cls, cmesh, array, *, origin=None, spatial_axes=(0, 1)):
        return cls(cmesh, array, origin or (0,) * np.ndim(array), _dims(np.ndim(array)),
                   spatial_axes=spatial_axes)

    def __repr__(self):
        return (f"DistributedField(global {self.global_shape}, block {self.index}, "
                f"dtype={self.dtype}, origin={self.origin}, {self.cmesh})")


def _dims(ndim: int):
    return ("I", "J", "K")[:ndim] + tuple(str(n) for n in range(ndim - 3))


def _local_block(array, sharding: FieldSharding):
    """This rank's block of a global array (numpy, tensor or
    ``FieldStorage``), as a tensor on the mesh's device."""
    if isinstance(array, FieldStorage):
        array = array.data
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.asarray(array))
    index = block_index(tuple(t.shape), sharding)
    block = t[tuple(slice(a, b) for a, b in index)]
    return block.to(sharding.cmesh.device).contiguous(), index


def distribute(cmesh, array, *, spatial_axes=(0, 1)) -> DistributedField:
    """This rank's block of the global (I, J, ...) array, as a
    ``DistributedField``.  ``cmesh`` may be a ``FieldSharding``."""
    sharding = _sharding(cmesh)
    if spatial_axes != (0, 1):
        sharding = FieldSharding(sharding.cmesh, tuple(spatial_axes))
    arr = array.data if isinstance(array, FieldStorage) else array
    ndim = len(arr.shape)
    return DistributedField(sharding.cmesh, arr, (0,) * ndim, _dims(ndim),
                            spatial_axes=sharding.spatial_axes)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def gather(array) -> np.ndarray:
    """The whole global array on every rank, as numpy (a collective for a
    ``DistributedField``: every rank of its mesh calls it).  Plain tensors,
    ``FieldStorage``s and arrays come back as they are, on the host."""
    if isinstance(array, DistributedField):
        return _gather_blocks(array.cmesh, _host(array.data), array.index, array.global_shape)
    if isinstance(array, FieldStorage):
        return array.to_numpy()
    if isinstance(array, torch.Tensor):
        return _host(array)
    return np.asarray(array)


def _gather_blocks(cmesh, block: np.ndarray, index, global_shape) -> np.ndarray:
    pieces = [(index, block)]
    if cmesh.distributed:
        pieces = [None] * dist.get_world_size()
        dist.all_gather_object(pieces, (index, block), group=cmesh.group)
    out = np.zeros(global_shape, dtype=block.dtype)
    for idx, b in pieces:
        out[tuple(slice(a, z) for a, z in idx)] = b
    return out


# --------------------------------------------------------------------------- #
# stencil calls on DistributedFields
# --------------------------------------------------------------------------- #


def _covers(outer: Extent, inner: Extent) -> bool:
    return (outer.i[0] <= inner.i[0] and inner.i[1] <= outer.i[1]
            and outer.j[0] <= inner.j[0] and inner.j[1] <= outer.j[1])


def _reads(expr) -> list:
    return [n for n in ir.walk_values(expr) if isinstance(n, ir.FieldAccess)]


def _tainted(stmt: ir.Stmt) -> set:
    """The fields a compound statement writes from values it wrote itself
    around the point: a read at a horizontal offset of a field it writes
    (after a write in its body, or in a ``while``'s next iteration), and
    what is computed from such a read or under a condition that holds
    one."""
    inner = {w.name for w in _stmt_writes(stmt)}
    tainted: set = set()

    def bad(reads) -> bool:
        return any(r.name in tainted or (r.name in inner and _ij(r.offset)) for r in reads)

    def visit(node, ctrl: bool) -> None:
        if isinstance(node, ir.Assign):
            reads = _reads(node.value) + [r for d in node.target.data_index for r in _reads(d)]
            if not isinstance(node.target.offset, ir.CartesianOffset):
                reads += _reads(node.target.offset.k)
            if ctrl or bad(reads):
                tainted.add(node.target.name)
        elif isinstance(node, (ir.If, ir.While)):
            c = ctrl or bad(_reads(node.cond))
            for s in node.body + getattr(node, "orelse", []):
                visit(s, c)
        elif isinstance(node, ir.HorizontalRestriction):
            for s in node.body:
                visit(s, ctrl)

    size = -1
    while size != len(tainted):  # a while's writes feed its next iteration
        size = len(tainted)
        visit(stmt, False)
    return tainted


def cross_rank_read(analysis) -> Optional[str]:
    """Why a rank could not compute its part of a call from one exchange
    before it (None: it can).  The exchange brings the values from before
    the call, and the extent analysis grows each statement so that a rank
    computes itself every value its part reads at the same level.  Two
    reads escape that, and need a value a neighbouring rank writes during
    the call:

    - a compound statement (``if``, ``while``, horizontal region) that
      reads at a horizontal offset a field it writes: at the rank's edge of
      the statement's points, the neighbour wrote the values read there.
      What is computed from them (``_tainted``) is wrong there unless an
      assignment of the same section overwrites it before it is read;
    - a FORWARD or BACKWARD loop reading, at another level, a field or
      temporary it writes (or any read of one it writes at a K offset), at
      points some writer of it in the loop does not compute (the writer's
      extent does not cover the read's): an earlier level's value there
      was computed by the neighbour."""
    st, ext = analysis.stencil, analysis.extents
    for loop in st.vertical_loops:
        for sec in loop.sections:
            for n, s in enumerate(sec.body):
                live = _tainted(s) if not isinstance(s, ir.Assign) else set()
                for later in sec.body[n + 1:]:
                    if not live:
                        break
                    read = live & {r.name for r in _stmt_reads(later)}
                    if read:
                        live = read
                        break
                    if isinstance(later, ir.Assign) and not later.target.data_index \
                            and later.target.offset == ir.CartesianOffset.zero():
                        live.discard(later.target.name)
                if live:
                    return (f"'{sorted(live)[0]}' is computed from a read at a horizontal "
                            "offset of a field written inside the same compound statement")
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            continue
        units = [s for sec in loop.sections for s in sec.body]
        writers: Dict[str, list] = {}
        shifted = set()  # written at a K offset: another level's writer
        for s in units:
            for w in _stmt_writes(s):
                writers.setdefault(w.name, []).append(s)
                if w.offset != ir.CartesianOffset.zero():
                    shifted.add(w.name)
        for s in units:
            for r in _stmt_reads(s):
                if r.name not in writers or (isinstance(r.offset, ir.CartesianOffset)
                                             and not r.offset.k and r.name not in shifted):
                    continue
                at = ext.stmt_extent(s)
                if isinstance(r.offset, ir.CartesianOffset):
                    at = at + Extent.from_offset(r.offset.i, r.offset.j)
                if not all(_covers(ext.stmt_extent(w), at) for w in writers[r.name]):
                    return (f"'{r.name}' is read at another level, at points its writer in "
                            f"the {loop.loop_order.name} loop does not compute")
    return None


def run_global(stencil, fields: Dict[str, DistributedField], scalars, origins, domain, *,
               physical: bool, periodic, validate_args: bool) -> Dict[str, DistributedField]:
    """``stencil``'s call on the global domain, from this rank's blocks:
    the written fields' new blocks.  ``origins``: each field's global
    buffer origin (I, J, K); ``domain``: the global compute domain (None:
    the largest the fields allow)."""
    if periodic:
        raise NotImplementedError("a call on DistributedFields takes no periodic=; exchange "
                                  "periodic halos with shard_map_stencil")
    if stencil.backend_name not in ("torch", "cuda"):
        raise NotImplementedError(f"backend {stencil.backend_name!r} runs on one host: a call "
                                  "on DistributedFields needs 'torch' or 'cuda'")
    why = cross_rank_read(stencil.analysis)
    if why:
        raise NotImplementedError(f"stencil '{stencil.name}' on DistributedFields: {why}, "
                                  "a value a neighbouring rank writes during the call")
    first = next(iter(fields.values()))
    cmesh = first.cmesh
    axes = (1, 2) if physical else (0, 1)  # the I and J tensor axes
    o = origins[next(iter(fields))]
    for name, f in fields.items():
        if not isinstance(f, DistributedField):
            raise TypeError(f"field '{name}' is not a DistributedField: mix none with them")
        if f.cmesh is not cmesh or f.sharding.spatial_axes != axes:
            raise ValueError(f"field '{name}' is not split over the call's I and J axes of "
                             "one mesh")
        if (f.global_shape[axes[0]], f.global_shape[axes[1]]) != (
                first.global_shape[axes[0]], first.global_shape[axes[1]]) \
                or tuple(origins[name][:2]) != tuple(o[:2]):
            raise ValueError("DistributedFields of one call share their I/J shape and origin")
    if domain is None:
        domain = stencil._get_max_domain(
            {n: _global_view(stencil, n, f, physical) for n, f in fields.items()}, origins)
    domain = tuple(int(d) for d in domain)
    # the halo the call reads and writes around its part of the domain
    halo = [0, 0]
    for name in fields:
        for ax in (0, 1):
            halo[ax] = max(halo[ax], *tuple(stencil.field_info[name].boundary)[ax])
    part, local_origin, frame = [], [], []
    for ax in (0, 1):
        b0, b1 = first.index[axes[ax]]
        p0, p1 = max(0, b0 - o[ax]), min(domain[ax], b1 - o[ax])
        if p1 <= p0:
            raise ValueError(f"rank {cmesh.rank}'s block {b0}:{b1} along {'IJ'[ax]} holds no "
                             f"point of the compute domain {o[ax]}:{o[ax] + domain[ax]}")
        part.append(p1 - p0)
        local_origin.append(o[ax] + p0 - (b0 - halo[ax]))
        frame.append(p0)
    blocks = {n: _pad(f.data, tuple(halo), axes) for n, f in fields.items()}
    HaloExchange(list(blocks.values()), tuple(halo), cmesh, spatial_axes=axes,
                 periodic=(False, False), boundary="zero").run()
    local_origins = {n: (local_origin[0], local_origin[1], origins[n][2]) for n in fields}
    outs = stencil._execute(blocks, scalars, local_origins, (part[0], part[1], domain[2]),
                            physical=physical, periodic=(), validate_args=validate_args,
                            frame=(frame[0], frame[1], domain[0], domain[1]))
    result = {}
    for name, t in outs.items():
        idx = [slice(None)] * t.ndim
        for ax in (0, 1):
            idx[axes[ax]] = slice(halo[ax], t.shape[axes[ax]] - halo[ax])
        result[name] = DistributedField.from_block(t[tuple(idx)].contiguous(), fields[name])
    return result


def _global_view(stencil, name, f: DistributedField, physical: bool):
    """A meta tensor of the global field's shape in the logical layout, for
    the domain inference."""
    from gt4py_tpu_torch.cartesian.stencil_object import logical_view

    decl = stencil.ir.field_decls[name]
    t = torch.empty(f.global_shape, device="meta")
    return logical_view(t, decl.dimensions, len(decl.data_dims), physical)
