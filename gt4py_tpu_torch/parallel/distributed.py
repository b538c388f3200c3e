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

A call whose blocks want a derivative differentiates as the single-device
call does (``jax.grad`` and ``jax.jvp`` of the JAX package's global view):
the first exchange under its transpose and its jvp (``halo._Exchange``),
then the call's own derivative -- the derivative stencils in the region
frame, or for a phased call one ``torch.autograd.Function``
(``_PhasedCall``) whose backward runs the call's adjoint stencil and whose
jvp runs its tangent stencil, each as a global-view call of its own (phased
in turn where its reads cross ranks), or re-runs the phased call on the
plain executor under autograd or forward AD where the derivative is one of
``derivative.PLAIN_RERUN``'s constructs.  A tensor scalar is replicated:
every rank holds it alike, its tangent is the same on every rank, and its
gradient is the ranks' partial gradients summed over the mesh
(``_Replicated``), so every rank holds ``jax.grad``'s.  A phased call with a
``while`` has no reverse-mode derivative, as ``jax.grad`` of the JAX
package's ``lax.while_loop`` has none (``PHASED_WHILE``); its jvp re-runs
the phases under forward AD.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

from gt4py_tpu_torch.cartesian import derivative, ir
from gt4py_tpu_torch.cartesian.backend.torch_backend import run_plain, wants_derivative
from gt4py_tpu_torch.cartesian.stencil_object import StencilObject, logical_view
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
        """A new block at ``like``'s place; on an axis the mesh does not
        split, the block is the whole axis (of its own size)."""
        shape, index = list(like.global_shape), list(like.index)
        for ax, n in enumerate(block.shape):
            if ax not in like.sharding.spatial_axes:
                shape[ax], index[ax] = n, (0, n)
        out = cls.__new__(cls)
        out._place(block, like.origin, like.dims, like.sharding, shape, index)
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


#: a reverse-mode derivative through a phased call that iterates a
#: ``while`` across the ranks: its trip count needs a tape, and the JAX
#: package's global view (``lax.while_loop``) has no reverse-mode derivative
#: either (its jvp re-runs the phases under forward AD)
PHASED_WHILE = "no derivative of a phased call with a while loop (as jax.grad of " \
               "lax.while_loop)"

#: what the last stencil call on DistributedFields of this process ran:
#: ``phased`` (False: one exchange, then the call), ``phases`` (the
#: stencils run: 1, or the plan's), ``runs`` (their runs, one a level or
#: an iteration), ``exchanges`` and ``bytes`` (the halo exchanges this rank
#: made, the first before the call included, and the bytes it sent),
#: ``levels`` (the level steps), ``iterations`` (each ``while``'s, in
#: order); for a phased ``"cuda"`` call on the card ``launches`` (the
#: kernel launches its stencils' libraries counted) and ``kernel_ms``
#: (phase stencil -> its runs' time on the stream, CUDA events around the
#: launches, summed); after the backward of a phased call, ``adjoint``: the
#: same record of its adjoint's global-view call (and its ``stencil``), or
#: of the phases' plain re-run (``plain`` true); after its jvp, ``tangent``:
#: the same of its tangent stencil's call or of the plain re-run
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
    values = [f.data for f in fields.values()] + list(scalars.values())
    if plan is not None and _iterates(plan.steps) and torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in values):
        raise NotImplementedError(PHASED_WHILE)
    grad = plan is not None and wants_derivative(values)
    scalars = {n: _Replicated.apply(cmesh, v) if isinstance(v, torch.Tensor) and
               wants_derivative([v]) else v for n, v in scalars.items()}
    blocks = {n: _pad(f.data, tuple(halo), axes) for n, f in fields.items()}
    first_exchange = HaloExchange(list(blocks.values()), tuple(halo), cmesh, spatial_axes=axes,
                                  periodic=(False, False), boundary="zero")
    blocks = dict(zip(blocks, first_exchange.run()))
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
        call = _PhasedRun(plan, stencil, cmesh, list(blocks), local_origins, part_domain, frame,
                          scalars, tuple(halo), physical, fields, origins, domain)
        views = call.views(blocks)
        if validate_args:
            stencil._validate_args(views, scalars, local_origins, part_domain)
        if grad:
            outs = dict(zip(call.written, _PhasedCall.apply(
                call, *blocks.values(), *[scalars[n] for n in call.tensor_scalars])))
        else:
            call.run(views)
            outs = {n: blocks[n] for n in call.written}
    result = {}
    for name, t in outs.items():
        idx = [slice(None)] * t.ndim
        for ax in (0, 1):
            idx[axes[ax]] = slice(halo[ax], t.shape[axes[ax]] - halo[ax])
        result[name] = DistributedField.from_block(t[tuple(idx)].contiguous(), fields[name])
    return result


def _iterates(steps) -> bool:
    """Whether a plan's steps iterate a ``while``."""
    for step in steps:
        if isinstance(step, phases.Iterate):
            return True
        if isinstance(step, phases.Levels) and any(_iterates(sub) for _, sub in step.sections):
            return True
    return False


class _PhasedRun:
    """One phased call on a rank's padded blocks: ``names`` the call's
    fields in order, ``written`` those it writes, ``tensor_scalars`` its
    scalars given as tensors (after the fields among the derivative's
    inputs), ``origins``, ``domain`` and ``frame`` the rank's part;
    ``fields``, ``global_origins`` and ``global_domain`` the global call,
    which the derivative stencils' own global-view calls follow."""

    def __init__(self, plan, stencil, cmesh, names, origins, domain, frame, scalars, halo,
                 physical, fields, global_origins, global_domain):
        self.plan, self.stencil, self.cmesh, self.names = plan, stencil, cmesh, list(names)
        self.origins, self.domain, self.frame, self.scalars = origins, domain, frame, scalars
        self.halo, self.physical, self.fields = halo, physical, fields
        self.global_origins, self.global_domain = global_origins, global_domain
        self.written = [n for n in self.names if stencil.field_info[n].access.value & 2]
        self.tensor_scalars = [n for n, v in scalars.items() if isinstance(v, torch.Tensor)]
        self.axes = (1, 2) if physical else (0, 1)
        self.record: Dict[str, object] = {}

    def views(self, blocks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The logical views of the padded ``blocks``."""
        views = {}
        for name, t in blocks.items():
            decl = self.stencil.ir.field_decls[name]
            views[name] = logical_view(t, decl.dimensions, len(decl.data_dims), self.physical)
        return views

    def run(self, views: Dict[str, torch.Tensor], plain: bool = False, rec=None,
            scalars=None) -> None:
        """The phased call in place on the blocks' logical ``views``
        (``plain``: each step on the plain executor), recorded in ``rec``
        (``LAST_GLOBAL``); ``scalars``: the call's, or these."""
        _Phased(self.plan, self.stencil, self.cmesh, views, self.origins, self.domain,
                self.frame, self.scalars if scalars is None else scalars, self.halo, plain,
                rec).run()

    def outputs(self, tensors, plain: bool = False, rec=None) -> tuple:
        """The written fields' new blocks from the ``_PhasedCall``'s inputs
        ``tensors`` (the blocks, then the tensor scalars), which stay as
        they are."""
        n = len(self.names)
        blocks = {nm: (t.clone() if nm in self.written else t)
                  for nm, t in zip(self.names, tensors[:n])}
        self.run(self.views(blocks), plain, rec, self._scalars(tensors))
        return tuple(blocks[nm] for nm in self.written)

    def _scalars(self, tensors) -> dict:
        return {**self.scalars, **dict(zip(self.tensor_scalars, tensors[len(self.names):]))}

    def inner(self, t: torch.Tensor) -> tuple:
        """The index of a padded block's own points."""
        idx = [slice(None)] * t.ndim
        for ax in (0, 1):
            idx[self.axes[ax]] = slice(self.halo[ax], t.shape[self.axes[ax]] - self.halo[ax])
        return tuple(idx)

    def _on_kernels(self, saved, kernels, rerun):
        """``kernels()``, the derivative stencil's call, on the card or with
        ``derivative="kernels"``; else (and for a construct of
        ``derivative.PLAIN_RERUN``) ``rerun()``, the plain re-run."""
        backend = self.stencil.backend
        forced = getattr(backend, "derivative_opt", None) == "kernels"
        if hasattr(backend, "derivative") and (
                forced or any(t.device.type == "cuda" for t in saved)):
            try:
                return kernels()
            except derivative.Declined as e:
                if forced or not e.reruns:
                    raise
        if hasattr(backend, "plain_reruns"):
            backend.plain_reruns += 1
        return rerun()

    def backward(self, saved, needs, grads) -> tuple:
        """The gradients of the ``_PhasedCall``'s inputs: the adjoint
        stencil's, or the plain re-run's."""
        return self._on_kernels(saved, lambda: self._adjoint(saved, needs, grads),
                                lambda: self._rerun(saved, needs, grads))

    def tangent(self, saved, tangents) -> tuple:
        """The written fields' tangents: the tangent stencil's, or the plain
        re-run's under forward AD."""
        return self._on_kernels(saved, lambda: self._tangent(saved, tangents),
                                lambda: self._tangent_rerun(saved, tangents))

    def _rerun(self, saved, needs, grads) -> tuple:
        """The phased call re-run on the plain executor under autograd, its
        exchanges under their transposes; an output the loss does not use
        brings a zero cotangent, so that every rank transposes the same
        exchanges."""
        rec = dict(phased=True, phases=1, runs=0, exchanges=0, bytes=0, levels=0,
                   iterations=[], plain=True)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            outs = self.outputs(leaves, plain=True, rec=rec)
            pairs = [(o, torch.zeros_like(o) if g is None else g)
                     for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                      allow_unused=True) if pairs and wrt else [None] * len(wrt)
        LAST_GLOBAL.clear()
        LAST_GLOBAL.update(self.record, adjoint=rec)
        it = iter(got)
        return tuple(next(it) if t.requires_grad else None for t in leaves)

    def _tangent_rerun(self, saved, tangents) -> tuple:
        """The phased call re-run on the plain executor on forward-mode
        duals, its exchanges carrying the tangents."""
        rec = dict(phased=True, phases=1, runs=0, exchanges=0, bytes=0, levels=0,
                   iterations=[], plain=True)
        with fwAD._set_fwd_grad_enabled(True):
            duals = [fwAD.make_dual(p.detach(), t) if t is not None and p.is_floating_point()
                     else p.detach() for p, t in zip(saved, tangents)]
            outs = self.outputs(duals, plain=True, rec=rec)
            tans = [fwAD.unpack_dual(o).tangent for o in outs]
        LAST_GLOBAL.clear()
        LAST_GLOBAL.update(self.record, tangent=rec)
        return tuple(torch.zeros_like(o) if t is None else t.clone() for o, t in zip(outs, tans))

    def _field(self, block: torch.Tensor, like: str) -> DistributedField:
        return DistributedField.from_block(block, self.fields[like])

    def _tangent(self, saved, tangents) -> tuple:
        """The call's tangent stencil (``CudaBackend.derivative``) as a
        global-view call of its own on the rank's blocks and their
        tangents (zeros where a field has none)."""
        from gt4py_tpu_torch.cartesian.backend.autodiff import _below_the_transform

        st, n = self.stencil, len(self.names)
        keys = self.names + self.tensor_scalars
        wanted = tuple(nm for nm, t, tan in zip(keys, saved, tangents)
                       if tan is not None and t.is_floating_point())
        d, obj = derivative_object(st, "tangent", wanted)
        with _below_the_transform() as peel:
            saved = [peel(t).detach() for t in saved]
            tans = dict(zip(keys, (None if t is None else peel(t).detach() for t in tangents)))
            fields, origins = {}, {}
            for nm, t in zip(self.names, saved):
                fields[nm], origins[nm] = self._field(t[self.inner(t)], nm), \
                    self.global_origins[nm]
                if nm in d.dots:
                    tan = tans[nm]
                    fields[d.dots[nm]] = self._field(
                        torch.zeros_like(fields[nm].data) if tan is None else
                        tan[self.inner(tan)].contiguous(), nm)
                    origins[d.dots[nm]] = self.global_origins[nm]
            scalars = self._scalars(saved)
            for nm in self.tensor_scalars:
                if nm in d.dots:
                    scalars[d.dots[nm]] = 0.0 if tans[nm] is None else tans[nm]
            out = run_global(obj, fields, scalars, origins, self.global_domain,
                             physical=self.physical, periodic=(), validate_args=False)
            tangent = dict(LAST_GLOBAL, stencil=d.stencil.name)
            LAST_GLOBAL.clear()
            LAST_GLOBAL.update(self.record, tangent=tangent)
            st.backend.tangent_calls += 1
            got = []
            for nm in self.written:
                t, tan = saved[self.names.index(nm)], tans[nm]
                full = torch.zeros_like(t) if tan is None else tan.clone()
                if nm in d.dots:
                    full[self.inner(full)] = out[d.dots[nm]].data
                got.append(full)
        return tuple(got)

    def _adjoint(self, saved, needs, grads) -> tuple:
        """The call's adjoint stencil (``CudaBackend.derivative``) as a
        global-view call of its own on the rank's blocks: the fields at
        their values before the call, the written fields' cotangents and
        the wanted fields' gradients, on the call's levels grown by
        ``k_grow``; each block padded in K with zeros where the adjoint's
        reads reach beyond it (their guards are false there).  The pieces
        the adjoint does not split as the call's fields -- a tensor
        scalar's per-point contribution, a wanted field's that lacks K, a
        written field's state and bar that lack K -- are split the same
        way: the contributions as 3-D fields of the call's I-J buffer, the
        states and bars as I-J fields; each rank sums its own points, never
        its halo (a tensor scalar's sum is summed over the ranks by
        ``_Replicated``)."""
        st, n = self.stencil, len(self.names)
        keys = self.names + self.tensor_scalars
        wanted = tuple(nm for nm, need in zip(keys, needs) if need)
        values = self._scalars(saved)
        bounds = {nm: int(values[nm]) for nm in derivative.runtime_bounds(st.ir)}
        dK = self.global_domain[2]
        d, obj = derivative_object(st, "adjoint", wanted, dK, bounds)
        kl, kh = d.k_grow
        kax = 0 if self.physical else 2
        blocks = {nm: t[self.inner(t)] for nm, t in zip(self.names, saved)}
        like = {nm: nm for nm in self.names}
        for nm, g in zip(self.written, grads):
            cot = torch.zeros_like(blocks[nm]) if g is None else g[self.inner(g)].contiguous()
            for idx, (state, bar) in d.planes.get(nm, {}).items():
                blocks[state] = blocks[nm][(Ellipsis,) + idx].contiguous()
                blocks[bar] = cot[(Ellipsis,) + idx].contiguous()
                like[state] = like[bar] = nm
            if nm in d.cots and nm not in d.planes:
                blocks[d.cots[nm]], like[d.cots[nm]] = cot, nm
        for nm, g in d.grads.items():
            if nm not in d.planes and nm not in d.sums:
                blocks[g] = blocks[d.cots[nm]].clone() if nm in d.passthrough else \
                    torch.zeros_like(blocks[nm])
                like[g] = nm
        levels = dK + kl + kh
        fields, origins, below = {}, {}, {}
        for name, b in blocks.items():
            ok = self.global_origins[like[name]][2] - kl
            pad = (0, 0)
            if obj.ir.field_decls[name].dimensions[2]:
                lo, hi = d.reach.get(name, (None, None, (0, 0)))[2]
                pad = (max(0, lo - ok), max(0, ok + levels + hi - b.shape[kax]))
            if pad != (0, 0):
                shape = list(b.shape)
                shape[kax] += pad[0] + pad[1]
                big = torch.zeros(shape, dtype=b.dtype, device=b.device)
                big.narrow(kax, pad[0], b.shape[kax]).copy_(b)
                b = big
            below[name] = pad[0]
            fields[name] = self._field(b, like[name])
            o = self.global_origins[like[name]]
            origins[name] = (o[0], o[1], ok + pad[0])
        # the per-point contributions: 3-D fields over the call's I-J buffer
        # and the adjoint's levels (the first at index 0)
        contribs = {c: levels for c in d.contribs.values()}
        contribs.update({d.grads[nm]: lv[1] for nm, (_, _, lv) in d.sums.items()})
        solid = next((nm for nm in self.names if all(st.ir.field_decls[nm].dimensions)), None)
        for c, nk in contribs.items():
            shape = list(blocks[solid].shape[:3])
            shape[kax] = nk
            fields[c] = self._field(torch.zeros(shape, dtype=blocks[solid].dtype,
                                                device=blocks[solid].device), solid)
            o = self.global_origins[solid]
            origins[c] = (o[0], o[1], 0)
        out = run_global(obj, fields, values, origins,
                         (self.global_domain[0], self.global_domain[1], levels),
                         physical=self.physical, periodic=(), validate_args=False)
        adjoint = dict(LAST_GLOBAL, stencil=d.stencil.name)
        LAST_GLOBAL.clear()
        LAST_GLOBAL.update(self.record, adjoint=adjoint)
        st.backend.adjoint_calls += 1
        got = []
        for nm, t, need in zip(self.names, saved, needs):
            if not need:
                got.append(None)
                continue
            if nm in d.planes:
                g = torch.zeros_like(blocks[nm])
                for idx, (_, bar) in d.planes[nm].items():
                    g[(Ellipsis,) + idx] = out[bar].data
            elif nm in d.sums:
                # a field that lacks K: its contribution summed over the levels
                g = out[d.grads[nm]].data.sum(dim=kax)
            else:
                g = out[d.grads[nm]].data.narrow(kax, below[d.grads[nm]], t.shape[kax])
            full = torch.zeros_like(t)
            full[self.inner(full)] = g
            got.append(full)
        for nm, t, need in zip(self.tensor_scalars, saved[n:], needs[n:]):
            got.append(out[d.contribs[nm]].data.sum().to(t.dtype).reshape(t.shape)
                       if need else None)
        return tuple(got)


def derivative_object(stencil, kind: str, wanted, dK: int = 0, bounds=None):
    """``stencil``'s ``kind`` derivative (``"adjoint"`` for the ``wanted``
    fields on ``dK`` levels, at the run-time interval bounds' values
    ``bounds``; ``"tangent"``: for the ``wanted`` fields' tangents) from
    ``CudaBackend.derivative`` (raises its ``Declined``), and a stencil
    object of it for its global-view call, made once for each such
    derivative (the object then keeps its phased plan, ``_plan_of``)."""
    bounds = bounds or {}
    if kind == "adjoint":
        d, backend = stencil.backend.derivative(kind, wanted, dK, (), bounds)
    else:
        d, backend = stencil.backend.derivative(kind, wanted)
    objs = stencil.__dict__.setdefault("_derivative_objects", {})
    key = (kind, tuple(wanted), int(dK), tuple(sorted(bounds.items())))
    if key not in objs:
        objs[key] = StencilObject(
            analysis=d.analysis, backend=backend, backend_name=stencil.backend_name,
            name=d.stencil.name, options=stencil.options,
            stencil_id=f"{stencil.stencil_id}:{d.stencil.name}")
    return d, objs[key]


class _PhasedCall(torch.autograd.Function):
    """A phased call as one differentiable operation.  Inputs: the
    ``_PhasedRun``, then the call's padded blocks (their halos exchanged,
    under the exchange's transpose and jvp), then its tensor scalars;
    outputs: the written fields' new blocks.  The forward is the phased
    run; the backward, ``_PhasedRun.backward``, gives the inputs' gradients
    (each block's own points, or partial sums the first exchange's
    transpose adds up; a tensor scalar's partial sum, which ``_Replicated``
    sums over the ranks); the jvp, ``_PhasedRun.tangent``, the outputs'
    tangents."""

    @staticmethod
    def forward(call: _PhasedRun, *tensors):
        out = call.outputs(tensors)
        call.record = dict(LAST_GLOBAL)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[0]
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*inputs[1:])
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ctx.call.backward(ctx.saved_tensors, ctx.needs_input_grad[1:], grads)

    @staticmethod
    def jvp(ctx, _, *tangents):
        return ctx.call.tangent(ctx.saved_tensors, tangents)


class _Replicated(torch.autograd.Function):
    """A tensor scalar of a call on DistributedFields, which every rank
    holds alike: its tangent is the same on every rank; its gradient, each
    rank's partial gradient (from the rank's part of the call), summed over
    the mesh's ranks (``all_reduce``), so every rank holds the gradient of
    the global call.  Every rank calls the backward."""

    @staticmethod
    def forward(cmesh, s):
        return s.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cmesh = inputs[0]

    @staticmethod
    def backward(ctx, g):
        cmesh = ctx.cmesh
        if not cmesh.distributed:
            return None, g
        dev = g.device if cmesh.backend == "nccl" else torch.device("cpu")
        total = g.detach().to(dev, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=cmesh.group)
        return None, total.to(g.device)

    @staticmethod
    def jvp(ctx, _, t):
        return t.clone()


class _Phased:
    """One phased call on a rank's padded blocks (logical ``views``, their
    ``origins``): the plan's held fields allocated on the padded block (K
    as each stencil of the plan reads them, zeros as the single-device
    temporaries start), each step run on its backend, and before a step
    the fields written since the last exchange exchanged (only the levels
    written, under ``Levels``)."""

    def __init__(self, plan, stencil, cmesh, views, origins, domain, frame, scalars, halo,
                 plain=False, rec=None):
        self.plan, self.cmesh, self.scalars, self.halo = plan, cmesh, scalars, tuple(halo)
        #: each step on its plain executor (the plain re-run under autograd)
        self.plain = plain
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
        self.rec = LAST_GLOBAL if rec is None else rec
        self.rec["phases"] = len(plan.onces)
        self.rec["runs"] = 0
        self.cuda = stencil.backend_name == "cuda" and some.device.type == "cuda" and not plain
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
            if self.plain:
                run_plain(getattr(step.backend, "plain", None) or step.backend.executor, env,
                          self.scalars, self.domain, origins, (), self.frame, levels)
            else:
                step.backend.apply(env, self.scalars, self.domain, origins, (),
                                   frame=self.frame, levels=levels)
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
        # under autograd (the plain re-run) a block a view each: an exchange
        # that fills views in place differentiates one tensor at a time
        for group in [[b] for b in blocks] if self.plain else [blocks]:
            ex = HaloExchange(group, self.halo, self.cmesh, spatial_axes=(0, 1),
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
