"""Explicit halo exchange between the ranks of a ``CartesianMesh``.

Counterpart of ``gt4py_tpu.parallel.halo``.  Each rank holds a local block
extended by halo rows and columns; neighbours swap edge strips with
``torch.distributed`` point-to-point operations (``batch_isend_irecv``).
Corners are handled by exchanging I first (strips over the whole J extent,
J halo included), then J (over the whole I extent, the I halo now filled):
the two-phase scheme that makes corner values travel two hops.

Boundaries per axis:

- periodic: the mesh axis is a ring;
- open: the edge ranks fill their outer halo per ``boundary``: ``"zero"``
  or ``"clamp"`` (edge-replicate, zero-gradient outflow);
- a mesh axis of size 1 fills locally (wrap, zero or clamp), with the same
  wire rounding, so an N=1 axis is bitwise equal to an N>1 one.

The wire: NCCL takes the strips as device tensors; gloo takes host
tensors, so CUDA strips are staged through pinned host buffers (device to
host, send/receive, host to device) and no CUDA tensor reaches gloo.
``LAST_EXCHANGE`` records what the last exchange of this process ran.

Derivatives: when a block wants one (``torch_backend.wants_derivative``: it
requires grad, carries a forward-mode tangent, or is wrapped by a
``torch.func`` transform), the exchange runs as one ``torch.autograd.Function``
(``_Exchange``) over all its blocks, which it fills in place
(``mark_dirty``, which autograd, forward AD and ``torch.func.grad`` / ``vjp``
/ ``jvp`` all accept).  Its jvp is the same exchange of the tangents, in
place: the same strips, periodic wrap, open edges and wire rounding
(``HaloExchange.tangent``), as ``jax.jvp`` of the JAX package's
``ppermute`` of the wired strips is.  Its backward is the exchange transposed
(``HaloExchange.transpose``): phase J's then phase I's, each received halo
strip's cotangent sent back to the rank that sent the strip, added into the
interior strip it came from and zeroed; a local wrap folds, an open edge
drops the cotangent (``"zero"``) or sums it into the edge plane
(``"clamp"``); a narrower wire rounds the cotangent strips as the forward
rounds the values.  It uses the forward's peers and staging with tags of
its own.  Every rank whose loss depends on any block of an exchange takes
part in its transpose (an output the loss does not use brings a zero
cotangent), so ``shard_map_stencil``, ``overlapped_shard_map_stencil`` and
the global view differentiate with every rank calling ``backward``.  A
differentiable exchange issues its messages when it completes (``wait``):
the overlapped step's interior then runs before the exchange, not beside
it.  ``LAST_TRANSPOSE`` records the last transposed exchange.

Overlap (``overlapped_shard_map_stencil``): the point-to-point operations
are issued first, the interior region (which reads no halo) is computed
from the blocks as they are while the strips travel (on the current CUDA
stream; the exchange's copies run on a stream of their own, and gloo's
sends and receives on gloo's threads), then the four boundary strips are
computed from the exchanged blocks and stitched in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gt4py_tpu_torch.cartesian.backend.torch_backend import wants_derivative
from gt4py_tpu_torch.core import dtypes

#: what the last halo exchange of this process ran: ``backend`` ("nccl",
#: "gloo" or "local": a mesh of one rank along every exchanged axis),
#: ``staged`` (strips copied through pinned host memory), ``bytes`` and
#: ``strips`` this rank sent (at the wire dtype), ``local_strips`` (filled
#: without a message: size-1 axes and open edges), ``wire_dtype``, ``fields``;
#: after a jvp also ``tangent_bytes``, ``tangent_strips`` and
#: ``tangent_fields``, what the tangents' exchange sent
LAST_EXCHANGE: Dict[str, object] = {}

#: what the last transposed exchange of this process ran (the keys of
#: ``LAST_EXCHANGE``) and ``seconds``, its time on the host clock (the
#: device waited for)
LAST_TRANSPOSE: Dict[str, object] = {}

#: the transposed exchange's tags lie above the forward's
_TRANSPOSE_TAG = 1 << 16


class _Exchange(torch.autograd.Function):
    """A ``HaloExchange`` completed on its blocks, in place, as one
    differentiable operation: the jvp exchanges the tangents, the backward
    is the transpose."""

    @staticmethod
    def forward(ex: "HaloExchange", *blocks):
        ex.blocks = list(blocks)
        ex._begin()
        return tuple(ex._wait())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ex = inputs[0]
        ctx.mark_dirty(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        cots = [g.clone() for g in grads]
        ctx.ex.transpose(cots)
        return (None, *cots)

    @staticmethod
    def jvp(ctx, _, *tangents):
        return tuple(ctx.ex.tangent(list(tangents)))


def _index(ndim: int, axis: int, start: int, stop: int) -> tuple:
    idx = [slice(None)] * ndim
    idx[axis] = slice(start, stop)
    return tuple(idx)


def _wire(strip: torch.Tensor, wire_dtype) -> torch.Tensor:
    """The strip as it travels: contiguous, at the wire dtype."""
    if wire_dtype is not None:
        strip = dtypes.cast(strip, wire_dtype)
    return strip.contiguous()


def _item(dt) -> int:
    return torch.empty((), dtype=dtypes.to_torch(dt)).element_size()


class HaloExchange:
    """One exchange of the halos of ``blocks`` (tensors on one device, all
    with the same spatial extents), filled in place: ``start()`` issues the
    I phase's messages, ``wait()`` completes it and runs the J phase (for
    blocks that want a derivative, ``wait()`` issues both, in ``_Exchange``).
    ``halo = (hi, hj)``; ``axes``: the mesh axis of each spatial axis."""

    def __init__(self, blocks: Sequence[torch.Tensor], halo: Tuple[int, int], cmesh, *,
                 axes=("x", "y"), spatial_axes=(0, 1), periodic=(True, True),
                 boundary: str = "zero", wire_dtype=None):
        if boundary not in ("zero", "clamp"):
            raise ValueError(f"boundary must be 'zero' or 'clamp', got {boundary!r}")
        self.blocks = list(blocks)
        self.halo = tuple(int(h) for h in halo)
        self.cmesh = cmesh
        self.axes = tuple(axes)
        self.spatial_axes = tuple(spatial_axes)
        self.periodic = tuple(bool(p) for p in periodic)
        self.boundary = boundary
        self.wire_dtype = wire_dtype
        dev = self.blocks[0].device if self.blocks else torch.device("cpu")
        self.staged = cmesh.backend == "gloo" and dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.record = {"backend": "local", "staged": False, "bytes": 0, "strips": 0,
                       "local_strips": 0, "fields": len(self.blocks),
                       "wire_dtype": None if wire_dtype is None else str(
                           dtypes.to_torch(wire_dtype)).replace("torch.", "")}
        self._pending = None
        #: whether ``start`` found a block that wants a derivative: then
        #: ``_Exchange`` issues the messages when the exchange completes
        self._differentiable = False
        for b in self.blocks:
            for n, a in enumerate(self.spatial_axes):
                if b.shape[a] < 3 * self.halo[n]:
                    raise ValueError(f"a block of {b.shape[a]} along axis {a} is too small "
                                     f"for a halo of {self.halo[n]}")

    # ------------------------------------------------------------------ #

    def start(self) -> "HaloExchange":
        self._differentiable = wants_derivative(self.blocks)
        if not self._differentiable:
            self._begin()
        return self

    def _begin(self) -> None:
        if self.stream is not None:
            # the strips are read after everything already queued on the
            # caller's stream (the blocks' padding)
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        self._pending = self._issue(0)

    def wait(self) -> List[torch.Tensor]:
        """Complete the exchange: the blocks with their halos filled (the
        same tensors; under a derivative, as ``_Exchange``'s outputs)."""
        if self._differentiable:
            self.blocks = list(_Exchange.apply(self, *self.blocks))
            return self.blocks
        return self._wait()

    def _wait(self) -> List[torch.Tensor]:
        self._finish(self._pending)
        self._finish(self._issue(1))
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)
            for b in self.blocks:
                b.record_stream(self.stream)
        LAST_EXCHANGE.clear()
        LAST_EXCHANGE.update(self.record)
        return self.blocks

    def run(self) -> List[torch.Tensor]:
        return self.start().wait()

    def tangent(self, tangents: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """The exchange's jvp, in place on ``tangents`` (shaped as the
        blocks; None: a block without one, which sends nothing): the
        values' exchange run on them, with the same peers, edges and wire.
        Every rank of the mesh calls it."""
        moving = [t for t in tangents if t is not None]
        record = dict(self.record, tangent_bytes=0, tangent_strips=0,
                      tangent_fields=len(moving))
        if moving:
            t = HaloExchange(moving, self.halo, self.cmesh, axes=self.axes,
                             spatial_axes=self.spatial_axes, periodic=self.periodic,
                             boundary=self.boundary, wire_dtype=self.wire_dtype)
            t.run()
            record.update(tangent_bytes=t.record["bytes"], tangent_strips=t.record["strips"])
        LAST_EXCHANGE.clear()
        LAST_EXCHANGE.update(record)
        return list(tangents)

    def transpose(self, cots: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The exchange transposed, in place on ``cots`` (cotangents shaped
        as the blocks): phase J's transpose, then phase I's.  Every rank
        of the mesh calls it."""
        t0 = time.perf_counter()
        t = HaloExchange(cots, self.halo, self.cmesh, axes=self.axes,
                         spatial_axes=self.spatial_axes, periodic=self.periodic,
                         boundary=self.boundary, wire_dtype=self.wire_dtype)
        if t.stream is not None:
            t.stream.wait_stream(torch.cuda.current_stream(t.stream.device))
        for n in (1, 0):
            t._finish(t._issue_transpose(n), add=True)
        if t.stream is not None:
            torch.cuda.current_stream(t.stream.device).wait_stream(t.stream)
            for b in t.blocks:
                b.record_stream(t.stream)
            torch.cuda.current_stream(t.stream.device).synchronize()
        LAST_TRANSPOSE.clear()
        LAST_TRANSPOSE.update(t.record, seconds=time.perf_counter() - t0)
        return t.blocks

    def _issue_transpose(self, n: int):
        """Post phase ``n``'s transposed messages: each halo strip's
        cotangent to the rank that sent the strip (or folded locally), the
        halo zeroed; the receives add into the interior strips sent."""
        h = self.halo[n]
        if h == 0 or not self.blocks:
            return None
        axis, array_axis, wrap = self.axes[n], self.spatial_axes[n], self.periodic[n]
        with self._ctx():
            if self.cmesh.axis_size(axis) == 1:
                for b in self.blocks:
                    self._fold_local(b, h, array_axis, wrap)
                return None
            lo_nb, hi_nb = self.cmesh.neighbours(axis, periodic=wrap)
            ops, recvs, keep, sent = [], [], [], []
            for f, b in enumerate(self.blocks):
                size = b.shape[array_axis]
                # my low halo came from the lower neighbour's high edge (tag
                # 2f), my high halo from the upper one's low edge (2f + 1)
                for peer, (d0, d1), tag in ((lo_nb, (0, h), 2 * f),
                                            (hi_nb, (size - h, size), 2 * f + 1)):
                    halo = b[_index(b.ndim, array_axis, d0, d1)]
                    if peer is None:
                        self._fold_edge(b, halo, h, array_axis, d0 == 0)
                        continue
                    buf = self._outgoing(_wire(halo, self.wire_dtype).clone())
                    keep.append(buf)
                    sent.append(halo)
                    ops.append(dist.P2POp(dist.isend, buf, peer, self.cmesh.group,
                                          _TRANSPOSE_TAG + tag))
                    self.record["bytes"] += buf.numel() * buf.element_size()
                    self.record["strips"] += 1
            if self.staged and keep:
                self.stream.synchronize()
            for halo in sent:
                halo.zero_()
            for f, b in enumerate(self.blocks):
                size = b.shape[array_axis]
                for peer, (s0, s1), tag in ((hi_nb, (size - 2 * h, size - h), 2 * f),
                                            (lo_nb, (h, 2 * h), 2 * f + 1)):
                    if peer is None:
                        continue
                    dst = b[_index(b.ndim, array_axis, s0, s1)]
                    buf = self._incoming(dst)
                    ops.append(dist.P2POp(dist.irecv, buf, peer, self.cmesh.group,
                                          _TRANSPOSE_TAG + tag))
                    recvs.append((dst, buf))
            self.record["backend"] = self.cmesh.backend
            self.record["staged"] = self.staged
            works = dist.batch_isend_irecv(ops) if ops else []
        return works, recvs, keep

    def _fold_local(self, b: torch.Tensor, h: int, axis: int, wrap: bool) -> None:
        """The transpose of ``_fill_local``."""
        size = b.shape[axis]
        lo, hi = _index(b.ndim, axis, 0, h), _index(b.ndim, axis, size - h, size)
        if not wrap:
            self._fold_edge(b, b[lo], h, axis, True)
            self._fold_edge(b, b[hi], h, axis, False)
            return
        lo_cot, hi_cot = self._round(b[lo]), self._round(b[hi])
        b[lo] = 0
        b[hi] = 0
        b[_index(b.ndim, axis, size - 2 * h, size - h)] += lo_cot
        b[_index(b.ndim, axis, h, 2 * h)] += hi_cot
        self.record["local_strips"] += 2

    def _fold_edge(self, b: torch.Tensor, halo: torch.Tensor, h: int, axis: int,
                   low: bool) -> None:
        """The transpose of ``_fill_edge``: ``"zero"`` drops the halo's
        cotangent, ``"clamp"`` adds it into the edge plane."""
        self.record["local_strips"] += 1
        if self.boundary == "clamp":
            size = b.shape[axis]
            at = h if low else size - h - 1
            b[_index(b.ndim, axis, at, at + 1)] += halo.sum(dim=axis, keepdim=True)
        halo.zero_()

    # ------------------------------------------------------------------ #

    def _ctx(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else \
            contextlib.nullcontext()

    def _issue(self, n: int):
        """Post phase ``n``'s sends and receives (or fill locally); returns
        what ``_finish`` completes."""
        h = self.halo[n]
        if h == 0 or not self.blocks:
            return None
        axis, array_axis, wrap = self.axes[n], self.spatial_axes[n], self.periodic[n]
        with self._ctx():
            if self.cmesh.axis_size(axis) == 1:
                for b in self.blocks:
                    self._fill_local(b, h, array_axis, wrap)
                return None
            lo_nb, hi_nb = self.cmesh.neighbours(axis, periodic=wrap)
            ops, recvs, keep = [], [], []
            for f, b in enumerate(self.blocks):
                size = b.shape[array_axis]
                # my interior's high edge -> the upper neighbour's low halo
                # (tag 2f), its low edge -> the lower neighbour's high halo
                for peer, (s0, s1), tag in ((hi_nb, (size - 2 * h, size - h), 2 * f),
                                            (lo_nb, (h, 2 * h), 2 * f + 1)):
                    if peer is None:
                        continue
                    buf = self._outgoing(b[_index(b.ndim, array_axis, s0, s1)])
                    keep.append(buf)
                    ops.append(dist.P2POp(dist.isend, buf, peer, self.cmesh.group, tag))
                    self.record["bytes"] += buf.numel() * buf.element_size()
                    self.record["strips"] += 1
            if self.staged and keep:
                self.stream.synchronize()
            for f, b in enumerate(self.blocks):
                size = b.shape[array_axis]
                for peer, (d0, d1), tag in ((lo_nb, (0, h), 2 * f), (hi_nb, (size - h, size),
                                                                   2 * f + 1)):
                    dst = b[_index(b.ndim, array_axis, d0, d1)]
                    if peer is None:
                        self._fill_edge(b, dst, h, array_axis, d0 == 0)
                        continue
                    buf = self._incoming(dst)
                    ops.append(dist.P2POp(dist.irecv, buf, peer, self.cmesh.group, tag))
                    recvs.append((dst, buf))
            self.record["backend"] = self.cmesh.backend
            self.record["staged"] = self.staged
            works = dist.batch_isend_irecv(ops) if ops else []
        return works, recvs, keep

    def _finish(self, pending, add: bool = False) -> None:
        if pending is None:
            return
        works, recvs, _keep = pending
        with self._ctx():
            for w in works:
                w.wait()
            for dst, buf in recvs:
                if add:
                    dst.add_(dtypes.cast(buf.to(dst.device, non_blocking=True), dst.dtype))
                    continue
                dst.copy_(dtypes.cast(buf.to(dst.device, non_blocking=True), dst.dtype)
                          if self.wire_dtype is not None else buf, non_blocking=True)
            if self.staged:
                # the pinned buffers are reused once the copies are done
                self.stream.synchronize()

    def _outgoing(self, strip: torch.Tensor) -> torch.Tensor:
        buf = _wire(strip, self.wire_dtype)
        if self.staged:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            return host
        return buf

    def _incoming(self, dst: torch.Tensor) -> torch.Tensor:
        dt = dst.dtype if self.wire_dtype is None else dtypes.to_torch(self.wire_dtype)
        if self.staged:
            return torch.empty(dst.shape, dtype=dt, pin_memory=True)
        return torch.empty(dst.shape, dtype=dt, device=dst.device)

    def _round(self, strip: torch.Tensor) -> torch.Tensor:
        """A strip as the wire would deliver it."""
        if self.wire_dtype is None:
            return strip.clone()
        return dtypes.cast(_wire(strip, self.wire_dtype), strip.dtype)

    def _fill_local(self, b: torch.Tensor, h: int, axis: int, wrap: bool) -> None:
        size = b.shape[axis]
        lo, hi = _index(b.ndim, axis, 0, h), _index(b.ndim, axis, size - h, size)
        if wrap:
            lo_strip = self._round(b[_index(b.ndim, axis, h, 2 * h)])
            hi_strip = self._round(b[_index(b.ndim, axis, size - 2 * h, size - h)])
            b[lo] = hi_strip
            b[hi] = lo_strip
            self.record["local_strips"] += 2
            return
        self._fill_edge(b, b[lo], h, axis, True)
        self._fill_edge(b, b[hi], h, axis, False)

    def _fill_edge(self, b: torch.Tensor, dst: torch.Tensor, h: int, axis: int,
                   low: bool) -> None:
        """An open edge's outer halo: zeros, or the edge plane repeated."""
        self.record["local_strips"] += 1
        if self.boundary == "zero":
            dst.zero_()
            return
        size = b.shape[axis]
        at = h if low else size - h - 1
        dst.copy_(b[_index(b.ndim, axis, at, at + 1)].expand_as(dst))


def halo_exchange(local: torch.Tensor, halo: Tuple[int, int], axes=("x", "y"),
                  spatial_axes=(0, 1), periodic: Tuple[bool, bool] = (True, True),
                  boundary: str = "zero", wire_dtype=None, *, cmesh) -> torch.Tensor:
    """This rank's block ``local`` with its halos swapped with the mesh
    neighbours (a new tensor; ``local`` is unchanged).

    ``spatial_axes`` selects the (I, J) tensor axes -- (0, 1) for logical
    (I, J, K) blocks, (1, 2) for the models' K-leading (K, I, J) layout.
    The I/J extents include the halo (ni + 2*hi etc.).  ``periodic`` picks
    ring or open per mesh axis; open edges fill their outer halo per
    ``boundary`` ("zero" | "clamp").  Every rank of ``cmesh`` calls it.

    ``wire_dtype`` (e.g. ``torch.bfloat16``) casts the exchanged strips to
    a narrower wire format before sending and back on arrival: the
    interior stays at full precision, only halo values round, once.
    """
    out = local.clone()
    HaloExchange([out], halo, cmesh, axes=axes, spatial_axes=spatial_axes, periodic=periodic,
                 boundary=boundary, wire_dtype=wire_dtype).run()
    return out


def _pad(arr: torch.Tensor, halo: Tuple[int, int], spatial_axes) -> torch.Tensor:
    """``arr`` inside a zero block grown by the halo on both sides."""
    hi, hj = halo
    ai, aj = spatial_axes
    shape = list(arr.shape)
    shape[ai] += 2 * hi
    shape[aj] += 2 * hj
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    out[_crop_index(out, halo, spatial_axes)] = arr
    return out


def _crop_index(b: torch.Tensor, halo: Tuple[int, int], spatial_axes) -> tuple:
    hi, hj = halo
    ai, aj = spatial_axes
    idx = [slice(None)] * b.ndim
    idx[ai] = slice(hi, b.shape[ai] - hi)
    idx[aj] = slice(hj, b.shape[aj] - hj)
    return tuple(idx)


def _split(kwargs, field_names, scalar_names):
    return ({n: kwargs[n] for n in field_names}, {n: kwargs[n] for n in scalar_names})


def shard_map_stencil(stencil_fn: Callable[..., Dict], cmesh, halo: Tuple[int, int], *,
                      field_names, scalar_names=(), spatial_axes=(0, 1),
                      periodic: Tuple[bool, bool] = (True, True), boundary: str = "zero",
                      extended_state: bool = False, halo_wire_dtype=None):
    """Wrap a local stencil function into a step over this rank's blocks.

    ``extended_state=False`` (default): the field arguments are the rank's
    interior blocks (ni, nj, ...).  Each is padded by the halo, the pad is
    filled from the neighbours, ``stencil_fn(**halo_extended_blocks,
    **scalars) -> dict(updated)`` runs (blocks of (ni + 2*hi, nj + 2*hj,
    ...), origin (hi, hj, 0), domain (ni, nj, K)), and the interiors of the
    updated fields come back.

    ``extended_state=True``: the fields stay in the halo-extended layout
    between steps (``to_extended`` / ``from_extended`` convert at the
    ends of the time loop); their halos are refreshed in place, with no
    per-step pad and crop copies.
    """
    field_names = tuple(field_names)
    scalar_names = tuple(scalar_names)

    def step(**kwargs):
        fields, scalars = _split(kwargs, field_names, scalar_names)
        padded = {n: a if extended_state else _pad(a, halo, spatial_axes)
                  for n, a in fields.items()}
        padded = dict(zip(padded, HaloExchange(
            list(padded.values()), halo, cmesh, spatial_axes=spatial_axes, periodic=periodic,
            boundary=boundary, wire_dtype=halo_wire_dtype).run()))
        merged = dict(padded)
        merged.update(stencil_fn(**padded, **scalars))
        if extended_state:
            return {n: merged[n] for n in field_names}
        return {n: merged[n][_crop_index(merged[n], halo, spatial_axes)] for n in field_names}

    return step


def overlap_regions(local_shape: Tuple[int, int], halo: Tuple[int, int]):
    """The interior region and the four boundary strips of a rank's step,
    as ((oi, oj), (di, dj)) in halo-extended local coordinates."""
    hi, hj = halo
    ni, nj = local_shape
    if ni <= 2 * hi or nj <= 2 * hj:
        raise ValueError(
            f"overlap needs local interior > 2*halo per axis, got {local_shape} vs {halo}")
    interior = ((2 * hi, 2 * hj), (ni - 2 * hi, nj - 2 * hj))
    strips = [
        ((hi, hj), (hi, nj)),                      # top rows (full width)
        ((ni, hj), (hi, nj)),                      # bottom rows
        ((2 * hi, hj), (ni - 2 * hi, hj)),         # left columns (minus corners)
        ((2 * hi, nj), (ni - 2 * hi, hj)),         # right columns
    ]
    return interior, strips


def overlapped_shard_map_stencil(make_region_step, cmesh, halo: Tuple[int, int], *,
                                 field_names, scalar_names=(), spatial_axes=(0, 1),
                                 periodic: Tuple[bool, bool] = (True, True),
                                 boundary: str = "zero", extended_state: bool = False,
                                 local_shape: Tuple[int, int], halo_wire_dtype=None):
    """A step over this rank's blocks with communication/computation overlap.

    ``make_region_step((oi, oj), (di, dj)) -> fn(**fields) -> dict`` returns
    a step computing the given region (origins in halo-extended local
    coordinates) that returns updated full blocks.  The wrapper issues the
    halo messages, computes the interior region (which reads no halo) from
    the blocks before the exchange, computes the four boundary strips from
    the exchanged blocks, and stitches the results.  ``local_shape``, the
    rank's interior (ni, nj), must exceed 2*halo on both axes.
    """
    field_names = tuple(field_names)
    scalar_names = tuple(scalar_names)
    ai, aj = spatial_axes
    interior, strips = overlap_regions(local_shape, halo)
    interior_fn = make_region_step(*interior)
    strip_fns = [make_region_step(o, d) for (o, d) in strips]

    def region_index(b, origin, domain):
        idx = [slice(None)] * b.ndim
        idx[ai] = slice(origin[0], origin[0] + domain[0])
        idx[aj] = slice(origin[1], origin[1] + domain[1])
        return tuple(idx)

    def step(**kwargs):
        fields, scalars = _split(kwargs, field_names, scalar_names)
        blocks = {n: a if extended_state else _pad(a, halo, spatial_axes)
                  for n, a in fields.items()}
        # under a derivative the exchange fills copies: the interior's call
        # keeps the blocks it read for its backward and jvp
        moved = [b.clone() for b in blocks.values()] if wants_derivative(blocks.values()) \
            else list(blocks.values())
        ex = HaloExchange(moved, halo, cmesh, spatial_axes=spatial_axes,
                          periodic=periodic, boundary=boundary,
                          wire_dtype=halo_wire_dtype).start()
        # the interior reads no halo: it runs while the strips travel
        before = blocks
        inner = interior_fn(**before, **scalars)
        blocks = dict(zip(before, ex.wait()))
        out = dict(blocks)
        out.update({n: v for n, v in inner.items() if v is not before.get(n)})
        for (origin, domain), fn in zip(strips, strip_fns):
            for name, b in fn(**blocks, **scalars).items():
                idx = region_index(b, origin, domain)
                if out[name] is blocks[name]:
                    out[name] = out[name].clone()
                out[name][idx] = b[idx]
        if extended_state:
            return {n: out[n] for n in field_names}
        return {n: out[n][_crop_index(out[n], halo, spatial_axes)] for n in field_names}

    return step


def to_extended(cmesh, array: torch.Tensor, halo: Tuple[int, int], spatial_axes=(0, 1)):
    """This rank's interior block in the persistent halo-extended layout
    (halos zero until the first exchange).  ``cmesh`` is kept for the JAX
    package's signature."""
    return _pad(array, halo, spatial_axes)


def from_extended(cmesh, array: torch.Tensor, halo: Tuple[int, int], spatial_axes=(0, 1)):
    """Crop this rank's halo-extended block back to its interior."""
    return array[_crop_index(array, halo, spatial_axes)]


def halo_comm_bytes(local_shape, halo: Tuple[int, int], dtype, spatial_axes=(0, 1),
                    wire_dtype=None, n_fields: int = 1) -> int:
    """Bytes ONE ``halo_exchange`` sends per rank per step over the wire
    (NCCL or gloo): two directions per mesh axis, strips of the halo width
    times the other dimensions, at the wire dtype (float32 strips halve
    at bfloat16).  ``local_shape`` is the halo-extended block's shape."""
    item = _item(wire_dtype if wire_dtype is not None else dtype)
    hi, hj = halo
    other = 1
    for ax, n in enumerate(local_shape):
        if ax not in spatial_axes:
            other *= n
    ni, nj = local_shape[spatial_axes[0]], local_shape[spatial_axes[1]]
    return 2 * (hi * nj + hj * ni) * other * item * n_fields
