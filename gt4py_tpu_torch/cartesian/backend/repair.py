"""K6 on Hopper: the geometry repair, kept as the JAX package's forced pass.

The counterpart of the JAX package's geometry repair
(``gt4py_tpu/cartesian/backend/pallas_backend.py``: ``_trace_repaired``
:483, ``_repair_pads`` :389, ``_padded_metas`` :441, ``_repair_cost_ok``
:455; its gate ``_halos_ij`` :946-978).  The TPU needs DMA windows on the
(8|16, 128) tiling and pads buffers to it.  The H100 needs no copy: what
Hopper's 16-byte copies need is an aligned source for each word, not one
phase across fields.  The tile and sweep kernels' staged inputs
(``cuda_backend._emit_staging``) start each row at the aligned-down word
of its first element, whatever the row's phase, and keep the row's lead;
the row form's vector kernels, which want one phase across their fields,
give way on a call that has none to the scalar row kernels, or with
``vector=True`` to their row-phase twins, which load each window from
its own aligned-down word and realign it in registers.  So no call is
repaired by default and nothing is left for a cost rule to decide.
``repair=True`` still runs the pass, with the JAX package's refusals:

- ``constraint`` reads a view's pointer and strides; ``common_phase``
  finds the J points that start words in every field (a call whose fields
  share one is refused: no repair applies).
- ``pads`` gives, for a call whose fields share no phase, per-field front
  and back pads on J (never on I: the copy is laid out (K, I, J) with its
  J rows a multiple of 16 bytes, so the level pitch follows) that give
  every field one phase; ``pad_fields`` copies in each field's read
  window into such a buffer (a field the kernels write everywhere they
  store, and never read, is not copied in), and ``write_back`` copies
  each written field's write window back, so every other byte of the
  caller's buffer keeps its value; ``copy_bytes`` counts what the copies
  move.

Periodic calls are not repaired (the JAX package's ``and not periodic``,
pallas_backend.py:250).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import _stmt_writes

#: the J phases a 16-byte word may start on: 16 lanes of 1 byte
MAX_LANES = 16

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def constraint(ptr: int, strides: Sequence[int], size: int) -> Optional[Tuple[int, int]]:
    """``(p, m)`` of a field whose domain origin is at address ``ptr``, with
    (I, J, K) element ``strides`` (0 on a broadcast axis) and items of
    ``size`` bytes: the J points ``j`` whose elements start 16-byte words
    are those with ``(p + j) % m == 0``, ``m`` = 16 / ``size``, in every
    row and level; None when no J point does in all of them (J not
    contiguous, or an I or K pitch that is not a multiple of 16 bytes)."""
    si, sj, sk = strides
    if 16 % size or sj != 1 or (si * size) % 16 or (sk * size) % 16:
        return None
    return (ptr % 16) // size, 16 // size


def common_phase(constraints: Sequence[Tuple[int, int]]) -> Optional[int]:
    """The smallest J phase (mod 16) that starts words in every field."""
    for ph in range(MAX_LANES):
        if all((p + ph) % m == 0 for p, m in constraints):
            return ph
    return None


def pads(views: Dict[str, torch.Tensor], origins,
         cons: Dict[str, Optional[Tuple[int, int]]]) -> Tuple[int, Dict[str, Pads]]:
    """``(phase, pads)``: the phase that the most of the fields ``cons``
    (their ``constraint``s) already take, by bytes, and the front and back
    J pads of a copy of each of them that does not."""
    best, best_bytes = 0, -1
    for ph in range(MAX_LANES):
        kept = sum(views[n].numel() * views[n].element_size() for n, c in cons.items()
                   if c is not None and (c[0] + ph) % c[1] == 0)
        if kept > best_bytes:
            best, best_bytes = ph, kept
    out: Dict[str, Pads] = {}
    for n, c in cons.items():
        if c is not None and (c[0] + best) % c[1] == 0:
            continue
        m = 16 // views[n].element_size()
        nj = views[n].shape[1]
        fj = (-best - origins[n][1]) % m
        out[n] = ((0, 0), (fj, (-(nj + fj)) % m))
    return best, out


def _window(view: torch.Tensor, origin, domain, extent) -> Tuple[slice, slice]:
    """The (I, J) slices of ``view`` that ``extent`` reaches around the
    domain, within the buffer."""
    out = []
    for ax in range(2):
        n = view.shape[ax]
        if n == 1:
            out.append(slice(0, 1))
            continue
        lo, hi = extent[ax]
        out.append(slice(max(0, origin[ax] + lo), min(n, origin[ax] + domain[ax] + hi)))
    return out[0], out[1]


def fully_written(analysis, name: str, kb: Sequence[Tuple[int, int]], dK: int) -> bool:
    """Every point of ``name``'s write window is written by the kernels:
    each writer is an unconditional top-level assignment over the whole
    write extent, and their sections cover every level of the domain.
    ``kb``: the resolved K bounds of the stencil's sections, in order."""
    ext = analysis.extents
    we = ext.write_extent(name)
    levels: List[Tuple[int, int]] = []
    sid = 0
    for loop in analysis.stencil.vertical_loops:
        for section in loop.sections:
            for s in section.body:
                if name not in {w.name for w in _stmt_writes(s)}:
                    continue
                e = ext.stmt_extent(s)
                if not isinstance(s, ir.Assign) or (e.i, e.j) != (we.i, we.j):
                    return False
                levels.append(kb[sid])
            sid += 1
    lo = 0
    for a, b in sorted(levels):
        if a > lo:
            break
        lo = max(lo, b)
    return lo >= dK


def copy_bytes(analysis, views, origins, domain, pads_: Dict[str, Pads], copied_in,
               written) -> int:
    """Bytes the repair's copies move: each window read once and written
    once, into the copy and back."""
    ext = analysis.extents
    total = 0
    for n in pads_:
        v = views[n]
        windows = []
        if n in copied_in:
            windows.append((ext.alloc_extent(n), v.shape[2]))
        if n in written:
            windows.append((ext.write_extent(n), min(v.shape[2], domain[2])))
        for e, nk in windows:
            si, sj = _window(v, origins[n], domain, (e.i, e.j))
            total += 2 * (si.stop - si.start) * (sj.stop - sj.start) * nk * v.element_size()
    return total


def pad_fields(analysis, views, origins, domain, pads_: Dict[str, Pads], copied_in):
    """The padded copies: ``(views, origins)`` with each field of ``pads_``
    replaced by a (K, I, J + pads) buffer, viewed as (I, J, K), that holds
    the field's read window (``copied_in``) at the same place relative to
    its origin."""
    ext = analysis.extents
    new_views, new_origins = dict(views), dict(origins)
    for n, ((_, _), (fj, bj)) in pads_.items():
        v, o = views[n], origins[n]
        ni, nj, nk = v.shape[:3]
        buf = torch.empty((nk, ni, nj + fj + bj), dtype=v.dtype, device=v.device)
        pv = buf.permute(1, 2, 0)
        if n in copied_in:
            e = ext.alloc_extent(n)
            si, sj = _window(v, o, domain, (e.i, e.j))
            pv[si, sj.start + fj: sj.stop + fj].copy_(v[si, sj])
        new_views[n] = pv
        new_origins[n] = (o[0], o[1] + fj, o[2])
    return new_views, new_origins


def write_back(analysis, views, origins, padded, domain, pads_: Dict[str, Pads], written):
    """Copy each written field's write window (its domain levels) from its
    padded copy into the caller's view."""
    ext = analysis.extents
    for n in written:
        if n not in pads_:
            continue
        v, o = views[n], origins[n]
        fj = pads_[n][1][0]
        e = ext.write_extent(n)
        si, sj = _window(v, o, domain, (e.i, e.j))
        k0 = o[2] if v.shape[2] != 1 else 0
        sk = slice(k0, min(v.shape[2], k0 + domain[2]))
        v[si, sj, sk].copy_(padded[n][si, sj.start + fj: sj.stop + fj, sk])
