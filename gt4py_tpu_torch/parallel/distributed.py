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

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.stencil_object import logical_view
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.storage import FieldStorage

from . import phases
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


def cross_rank_read(analysis) -> Optional[str]:
    """Why a rank could not compute its part of a call from one exchange
    before it (None: it can); such a call runs in phases (``phases``).
    The exchange brings the values from before the call, and the extent
    analysis grows each statement so that a rank computes itself every
    value its part reads at the same level.  Two reads escape that, and
    need a value a neighbouring rank writes during the call:

    - a compound statement (``if``, ``while``, horizontal region) that
      reads at a horizontal offset a field it writes: at the rank's edge of
      the statement's points, the neighbour wrote the values read there.
      What is computed from them (``phases.tainted``) is wrong there unless
      an assignment of the same section overwrites it before it is read;
    - a FORWARD or BACKWARD loop reading, at another level, a field or
      temporary it writes at points some writer of it in the loop does not
      compute (``phases.cross_level``)."""
    for loop in analysis.stencil.vertical_loops:
        for sec in loop.sections:
            for n in range(len(sec.body)):
                live = phases.live_taint(sec.body, n)
                if live:
                    return (f"'{sorted(live)[0]}' is computed from a read at a horizontal "
                            "offset of a field written inside the same compound statement")
        why = phases.cross_level(loop, analysis.extents)
        if why:
            return why
    return None


#: what the last stencil call on DistributedFields of this process ran:
#: ``phased`` (False: one exchange, then the call), ``phases`` (the
#: stencils run: 1, or the plan's), ``runs`` (their runs, one a level or
#: an iteration), ``exchanges`` and ``bytes`` (the halo exchanges this rank
#: made, the first before the call included, and the bytes it sent),
#: ``levels`` (the level steps), ``iterations`` (each ``while``'s, in
#: order); for a phased ``"cuda"`` call on the card ``launches`` (the
#: kernel launches its stencils' libraries counted) and ``kernel_ms``
#: (phase stencil -> its runs' time on the stream, CUDA events around the
#: launches, summed)
LAST_GLOBAL: Dict[str, object] = {}


def _plan_of(stencil):
    """The stencil's phased plan (``phases.plan``), made once."""
    got = stencil.__dict__.get("_phase_plan")
    if got is None:
        from gt4py_tpu_torch.cartesian.backend import from_name

        got = stencil.__dict__["_phase_plan"] = phases.plan(
            stencil.analysis, from_name(stencil.backend_name), stencil.options)
    return got


def run_global(stencil, fields: Dict[str, DistributedField], scalars, origins, domain, *,
               physical: bool, periodic, validate_args: bool) -> Dict[str, DistributedField]:
    """``stencil``'s call on the global domain, from this rank's blocks:
    the written fields' new blocks.  ``origins``: each field's global
    buffer origin (I, J, K); ``domain``: the global compute domain (None:
    the largest the fields allow).  A stencil that ``cross_rank_read``
    names runs in phases (``phases.plan``), with an exchange between them;
    ``LAST_GLOBAL`` records what the call ran."""
    if periodic:
        raise NotImplementedError("a call on DistributedFields takes no periodic=; exchange "
                                  "periodic halos with shard_map_stencil")
    if stencil.backend_name not in ("torch", "cuda"):
        raise NotImplementedError(f"backend {stencil.backend_name!r} runs on one host: a call "
                                  "on DistributedFields needs 'torch' or 'cuda'")
    plan = _plan_of(stencil) if cross_rank_read(stencil.analysis) else None
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
    bounds = [fi.boundary for fi in stencil.field_info.values()]
    for once in plan.onces if plan else ():
        ext = once.analysis.extents
        bounds += [fi.boundary for fi in once.analysis.field_info.values()]
        bounds += [ext.boundary(n) for n in once.analysis.stencil.temp_decls]
    for b in bounds:
        for ax in (0, 1):
            halo[ax] = max(halo[ax], *tuple(b)[ax])
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
    first_exchange = HaloExchange(list(blocks.values()), tuple(halo), cmesh, spatial_axes=axes,
                                  periodic=(False, False), boundary="zero")
    first_exchange.run()
    local_origins = {n: (local_origin[0], local_origin[1], origins[n][2]) for n in fields}
    part_domain = (part[0], part[1], domain[2])
    frame = (frame[0], frame[1], domain[0], domain[1])
    LAST_GLOBAL.clear()
    LAST_GLOBAL.update(phased=plan is not None, phases=1, runs=1, exchanges=1,
                       bytes=first_exchange.record["bytes"], levels=0, iterations=[])
    if plan is None:
        outs = stencil._execute(blocks, scalars, local_origins, part_domain,
                                physical=physical, periodic=(), validate_args=validate_args,
                                frame=frame)
    else:
        views = {}
        for name, t in blocks.items():
            decl = stencil.ir.field_decls[name]
            views[name] = logical_view(t, decl.dimensions, len(decl.data_dims), physical)
        if validate_args:
            stencil._validate_args(views, scalars, local_origins, part_domain)
        _Phased(plan, stencil, cmesh, views, local_origins, part_domain, frame, scalars,
                halo).run()
        outs = {n: blocks[n] for n in fields if stencil.field_info[n].access.value & 2}
    result = {}
    for name, t in outs.items():
        idx = [slice(None)] * t.ndim
        for ax in (0, 1):
            idx[axes[ax]] = slice(halo[ax], t.shape[axes[ax]] - halo[ax])
        result[name] = DistributedField.from_block(t[tuple(idx)].contiguous(), fields[name])
    return result


class _Phased:
    """One phased call on a rank's padded blocks (logical ``views``, their
    ``origins``): the plan's held fields allocated on the padded block (K
    as each stencil of the plan reads them, zeros as the single-device
    temporaries start), each step run on its backend, and before a step
    the fields written since the last exchange exchanged (only the levels
    written, under ``Levels``)."""

    def __init__(self, plan, stencil, cmesh, views, origins, domain, frame, scalars, halo):
        self.plan, self.cmesh, self.scalars, self.halo = plan, cmesh, scalars, tuple(halo)
        self.domain, self.frame = domain, frame
        self.env = dict(views)
        self.origins = dict(origins)
        self.fields = stencil.ir.field_decls
        some = next(iter(views.values()))
        ni, nj = some.shape[0], some.shape[1]
        oi, oj = next(iter(origins.values()))[:2]
        self.corner = (oi, oj)
        for name, decl in plan.held().items():
            lo = hi = 0
            for once in plan.onces:
                if name in once.analysis.stencil.temp_decls:
                    k = once.analysis.extents.alloc_extent(name).k
                    lo, hi = max(lo, -k[0]), max(hi, k[1])
            self.env[name] = torch.zeros((ni, nj, domain[2] + lo + hi) + tuple(decl.data_dims),
                                         dtype=dtypes.to_torch(decl.dtype), device=some.device)
            self.origins[name] = (oi, oj, lo)
        self.dirty: Dict[str, Optional[Tuple[int, int]]] = {}
        self.rec = LAST_GLOBAL
        self.rec["phases"] = len(plan.onces)
        self.rec["runs"] = 0
        self.cuda = stencil.backend_name == "cuda" and some.device.type == "cuda"
        self.events: List[tuple] = []

    def run(self) -> None:
        if self.cuda:
            counted = self._build()
        for step in self.plan.steps:
            self._step(step, None)
        if self.cuda:
            from gt4py_tpu_torch.cartesian.backend.cuda_backend import library_launches

            self.rec["launches"] = library_launches() - counted
        if self.events:
            self.events[-1][2].synchronize()
            ms: Dict[str, float] = {}
            for name, a, b in self.events:
                ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
            self.rec["kernel_ms"] = ms

    def _build(self) -> int:
        """Every stencil's library, built on rank 0 first (the others load
        its build); the libraries' launch count before the call."""
        from gt4py_tpu_torch.cartesian.backend.cuda_backend import library_launches

        if self.cmesh.distributed and not all(o.backend._lib for o in self.plan.onces):
            if self.cmesh.rank == 0:
                for once in self.plan.onces:
                    once.backend.build()
            dist.barrier(group=self.cmesh.group)
        for once in self.plan.onces:
            once.backend.build()
        return library_launches()

    def _step(self, step, levels) -> None:
        if isinstance(step, phases.Levels):
            for interval, sub in step.sections:
                k0, k1 = self._levels(interval)
                ks = range(k0, k1) if step.order == ir.LoopOrder.FORWARD else \
                    range(k1 - 1, k0 - 1, -1)
                for k in ks:
                    self.rec["levels"] += 1
                    for s in sub:
                        self._step(s, (k, k + 1))
        elif isinstance(step, phases.Iterate):
            self._exchange()
            n = 0
            while self._active(step, levels):
                for s in step.body:
                    self._step(s, levels)
                self._exchange()
                n += 1
            self.rec["iterations"].append(n)
        else:
            self._exchange()
            st = step.analysis.stencil
            names = {*st.field_decls, *st.temp_decls}
            env = {n: t for n, t in self.env.items() if n in names}
            origins = {n: self.origins[n] for n in env}
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            step.backend.apply(env, self.scalars, self.domain, origins, (), frame=self.frame,
                               levels=levels)
            if self.cuda:
                ev[1].record()
                self.events.append((st.name, *ev))
            self.rec["runs"] += 1
            for name, koffs in step.writes.items():
                if levels is None or koffs is None:
                    self.dirty[name] = None
                    continue
                lo, hi = levels[0] + koffs[0], levels[1] + koffs[1]
                if name in self.dirty:
                    if self.dirty[name] is None:
                        continue
                    lo, hi = min(lo, self.dirty[name][0]), max(hi, self.dirty[name][1])
                self.dirty[name] = (lo, hi)

    def _levels(self, interval) -> Tuple[int, int]:
        dK = self.domain[2]
        k0, k1 = interval.resolve(dK, self.scalars)
        return max(k0, 0), min(k1, dK)

    def _exchange(self) -> None:
        """The halos of the fields written since the last exchange: each
        at the levels written (K windows in domain levels), or whole."""
        if not self.dirty:
            return
        blocks = []
        for name, win in self.dirty.items():
            t = self.env[name]
            decl = self.fields.get(name) or self.plan.held()[name]
            if win is not None and decl.dimensions[2] and t.shape[2] > 1:
                ok = self.origins[name][2]
                t = t[:, :, max(0, ok + win[0]): min(t.shape[2], ok + win[1])]
            blocks.append(t)
        self.dirty.clear()
        ex = HaloExchange(blocks, self.halo, self.cmesh, spatial_axes=(0, 1),
                          periodic=(False, False), boundary="zero")
        ex.run()
        self.rec["bytes"] += ex.record["bytes"]
        self.rec["exchanges"] += 1

    def _active(self, step, levels) -> bool:
        """Whether a point of the ``while``'s flag holds on some rank:
        this rank's part grown by the loop's extent, at its levels."""
        e, (oi, oj) = step.extent, self.corner
        k0, k1 = levels if levels is not None else self._levels(step.interval)
        a = self.env[step.active]
        ok = self.origins[step.active][2]
        here = bool(a[oi + e.i[0]: oi + self.domain[0] + e.i[1],
                      oj + e.j[0]: oj + self.domain[1] + e.j[1], ok + k0: ok + k1].any())
        if not self.cmesh.distributed:
            return here
        dev = a.device if self.cmesh.backend == "nccl" else torch.device("cpu")
        flag = torch.tensor([int(here)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.cmesh.group)
        return bool(flag.item())


def _global_view(stencil, name, f: DistributedField, physical: bool):
    """A meta tensor of the global field's shape in the logical layout, for
    the domain inference."""
    decl = stencil.ir.field_decls[name]
    t = torch.empty(f.global_shape, device="meta")
    return logical_view(t, decl.dimensions, len(decl.data_dims), physical)
