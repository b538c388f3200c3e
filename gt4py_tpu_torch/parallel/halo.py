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

Overlap (``overlapped_shard_map_stencil``): the point-to-point operations
are issued first, the interior region (which reads no halo) is computed
from the blocks as they are while the strips travel (on the current CUDA
stream; the exchange's copies run on a stream of their own, and gloo's
sends and receives on gloo's threads), then the four boundary strips are
computed from the exchanged blocks and stitched in.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from gt4py_tpu_torch.core import dtypes

#: what the last halo exchange of this process ran: ``backend`` ("nccl",
#: "gloo" or "local": a mesh of one rank along every exchanged axis),
#: ``staged`` (strips copied through pinned host memory), ``bytes`` and
#: ``strips`` this rank sent (at the wire dtype), ``local_strips`` (filled
#: without a message: size-1 axes and open edges), ``wire_dtype``, ``fields``
LAST_EXCHANGE: Dict[str, object] = {}


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
    I phase's messages, ``wait()`` completes it and runs the J phase.
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
        for b in self.blocks:
            for n, a in enumerate(self.spatial_axes):
                if b.shape[a] < 3 * self.halo[n]:
                    raise ValueError(f"a block of {b.shape[a]} along axis {a} is too small "
                                     f"for a halo of {self.halo[n]}")

    # ------------------------------------------------------------------ #

    def start(self) -> "HaloExchange":
        if self.stream is not None:
            # the strips are read after everything already queued on the
            # caller's stream (the blocks' padding)
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        self._pending = self._issue(0)
        return self

    def wait(self) -> List[torch.Tensor]:
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

    def _finish(self, pending) -> None:
        if pending is None:
            return
        works, recvs, _keep = pending
        with self._ctx():
            for w in works:
                w.wait()
            for dst, buf in recvs:
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
        HaloExchange(list(padded.values()), halo, cmesh, spatial_axes=spatial_axes,
                     periodic=periodic, boundary=boundary, wire_dtype=halo_wire_dtype).run()
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
        ex = HaloExchange(list(blocks.values()), halo, cmesh, spatial_axes=spatial_axes,
                          periodic=periodic, boundary=boundary,
                          wire_dtype=halo_wire_dtype).start()
        # the interior reads no halo: it runs while the strips travel
        out = dict(blocks)
        out.update(interior_fn(**blocks, **scalars))
        ex.wait()
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
