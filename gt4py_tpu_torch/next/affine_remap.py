"""Affine-window gathers for quasi-structured connectivity tables.

The counterpart of ``gt4py_tpu.next.affine_remap``.  Meshes produced by
structured-grid tooling -- and the large interior regions of most
production meshes -- have neighbor tables that are piecewise 2D-affine:
within a block of consecutive elements,

    table[e, k] == v0 + A * (e // C) + (e % C)

(C = elements per mesh row, A = codomain row stride).  For such blocks
the gather is a dense strided window: slice ``R*A`` contiguous rows,
reshape to ``(R, A)``, keep the first ``C`` lanes per row -- contiguous
copies (or views) in place of a scattered gather, with a small index
patch for the boundary entries the affine model misses.

The planner is the JAX package's, unchanged (pure numpy), so the same
tables give the same plans:

- :func:`build_table_plan` fits each neighbor column with up to
  ``2**_MAX_SPLITS`` affine blocks (splitting at the largest
  discontinuity), trying phase interleavings p = 1..4 when the plain fit
  fails, and records every mispredicted entry as residual; plans whose
  residual fraction exceeds ``_MAX_RESIDUAL`` are rejected.
- :func:`apply_table_plan` replays a plan along any axis with torch
  slices (``narrow``), reshapes and concatenations -- no kernel: the JAX
  package's replay is XLA slicing too -- bit-identically to the clipped
  ``index_select`` base path (the residual patch uses that gather itself),
  and declines when the runtime domain does not cover the table's value
  range.

The numpy oracle keeps the plain take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config

#: residual fraction above which a column plan is rejected
_MAX_RESIDUAL = 0.10
#: recursive family splits per column (2**splits blocks max)
_MAX_SPLITS = 3
#: accept a family fit when its mismatch fraction is at most this
_FIT_ACCEPT = 0.10
#: tables smaller than this are not worth planning
_MIN_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class Block:
    """``table[e, k] == v0 + A*((e - e0) // C) + ((e - e0) % C)`` for
    ``e in [e0, e1)`` (up to residual entries)."""

    e0: int
    e1: int
    C: int
    A: int
    v0: int

    @property
    def rows(self) -> int:
        return -(-(self.e1 - self.e0) // self.C)


@dataclasses.dataclass(frozen=True)
class ColumnPlan:
    """``phases[t]`` are the affine blocks of the subsequence
    ``col[t::p]`` (p = len(phases)); p == 1 is the plain case.  p > 1
    captures interleaved tables -- e.g. structured triangle meshes,
    where even/odd cells (the two triangles of each quad) are separate
    affine families woven together.  Residual positions are in full
    column coordinates either way."""

    phases: Tuple[Tuple[Block, ...], ...]
    res_pos: np.ndarray  # int64 positions into [0, n)
    res_idx: np.ndarray  # raw table values at those positions


@dataclasses.dataclass(frozen=True)
class TablePlan:
    n: int
    cols: Tuple[ColumnPlan, ...]
    vmin: int  # min/max predicted index over all non-residual entries
    vmax: int

    @property
    def n_cols(self) -> int:
        return len(self.cols)


def _mode(arr: np.ndarray) -> int:
    """Most frequent value of an integer array (robust location fit).
    bincount only when the value range is comparable to the array size:
    bad candidate strides produce ranges of ~1e9+ and bincount+argmax
    would scan gigabytes per candidate (55 s rejection for an irregular
    500k-row table, vs ~1 s with the unique fallback)."""
    if arr.size == 0:
        return 0
    lo = int(arr.min())
    span = int(arr.max()) - lo
    if span <= 4 * arr.size + (1 << 20):
        counts = np.bincount(arr - lo)
        return int(np.argmax(counts)) + lo
    vals, counts = np.unique(arr, return_counts=True)
    return int(vals[np.argmax(counts)])


def _predict(block_C: int, block_A: int, v0: int, length: int) -> np.ndarray:
    q, m = np.divmod(np.arange(length, dtype=np.int64), block_C)
    return v0 + block_A * q + m


def _fit_segment(col: np.ndarray) -> Optional[Tuple[int, int, int, float]]:
    """Best (C, A, v0, mismatch_fraction) for one contiguous segment."""
    L = len(col)
    if L < 2:
        return None
    candidates = []
    # pure-shift fit: one row spanning the segment
    v0 = _mode(col - np.arange(L, dtype=np.int64))
    candidates.append((L, L, v0))
    # run-structured fits: row length from the diff==1 run statistics
    runs = np.flatnonzero(np.diff(col) != 1)
    if runs.size:
        lengths = np.diff(np.concatenate([[-1], runs, [L - 1]]))
        vals, counts = np.unique(lengths, return_counts=True)
        top = vals[np.argsort(-counts)][:3]
        for base in top:
            for C in (int(base), int(base) + 1, int(base) + 2):
                if not 1 <= C < L:
                    continue
                A = _mode(col[C:] - col[:-C])
                if A < 1:
                    continue
                q, m = np.divmod(np.arange(L, dtype=np.int64), C)
                v0 = _mode(col - A * q - m)
                candidates.append((C, A, v0))
    best = None
    for C, A, v0 in candidates:
        if A < 1 or C < 1:
            continue
        miss = float(np.count_nonzero(_predict(C, A, v0, L) != col)) / L
        if best is None or miss < best[3]:
            best = (C, A, v0, miss)
        if best[3] == 0.0:
            break
    return best


def _fit_family(col: np.ndarray, e0: int, depth: int) -> Optional[list]:
    fit = _fit_segment(col)
    if fit is not None and fit[3] <= _FIT_ACCEPT:
        C, A, v0, _ = fit
        return [Block(e0, e0 + len(col), C, A, v0)]
    if depth == 0 or len(col) < 2 * _MIN_SIZE // 4:
        return None
    # split at the largest discontinuity (family boundary) and recurse
    cut = int(np.argmax(np.abs(np.diff(col)))) + 1
    if cut <= 1 or cut >= len(col) - 1:
        return None
    left = _fit_family(col[:cut], e0, depth - 1)
    if left is None:
        return None
    right = _fit_family(col[cut:], e0 + cut, depth - 1)
    if right is None:
        return None
    return left + right


def _plan_column(
    col: np.ndarray, skip_value: Optional[int]
) -> Optional[ColumnPlan]:
    phases = None
    for p in (1, 2, 3, 4):
        if len(col) // p < _MIN_SIZE // 4:
            break
        fits = []
        for t in range(p):
            blocks = _fit_family(col[t::p], 0, _MAX_SPLITS)
            if not blocks:
                break
            fits.append(tuple(blocks))
        if len(fits) == p:
            phases = tuple(fits)
            break
    if phases is None:
        return None
    predicted = np.empty_like(col)
    for t, blocks in enumerate(phases):
        predicted[t :: len(phases)] = np.concatenate(
            [_predict(b.C, b.A, b.v0, b.e1 - b.e0) for b in blocks]
        )
    bad = predicted != col
    if skip_value is not None:
        # skip entries are residual even when an affine line happens to
        # pass through them: they must keep the base path's clip
        # semantics, and must not enter the plan's value range
        bad |= col == skip_value
    res = np.flatnonzero(bad)
    if res.size > _MAX_RESIDUAL * len(col):
        return None
    return ColumnPlan(phases, res.astype(np.int64), col[res].copy())


def build_table_plan(
    table: np.ndarray, skip_value: Optional[int] = None
) -> Optional[TablePlan]:
    """Fit a (n, k) neighbor table; None when no profitable plan exists."""
    table = np.asarray(table)
    if table.ndim != 2 or table.size < _MIN_SIZE:
        return None
    cols = []
    vmin, vmax = None, None
    for k in range(table.shape[1]):
        cp = _plan_column(table[:, k].astype(np.int64), skip_value)
        if cp is None:
            return None
        cols.append(cp)
        keep = np.ones(table.shape[0], dtype=bool)
        keep[cp.res_pos] = False
        if keep.any():
            colv = table[:, k][keep]
            cmin, cmax = int(colv.min()), int(colv.max())
            vmin = cmin if vmin is None else min(vmin, cmin)
            vmax = cmax if vmax is None else max(vmax, cmax)
    if vmin is None:
        return None
    return TablePlan(table.shape[0], tuple(cols), vmin, vmax)


def table_token(table) -> tuple:
    """Cheap identity token for a (possibly replaced) numpy table: object
    id + shape/dtype + a strided content sample.  id() alone is unsafe
    (a replaced table's allocation can land at the freed address); the
    sample catches that without hashing the full table on a hot path."""
    if not isinstance(table, np.ndarray):
        return (id(table),)
    step = max(1, table.shape[0] // 64)
    sample = np.ascontiguousarray(table[::step][:64])
    return (id(table), table.shape, str(table.dtype), hash(sample.tobytes()))


def plan_for(conn) -> Optional[TablePlan]:
    """Cached plan for a Connectivity (built once per table; None when
    ``config.AFFINE_GATHER`` is off, read on every call).  1-D tables
    (neighbor columns, concrete as_offset mappings) plan as a single
    column; callers drop the unit local axis from the applied result.

    The cache is keyed on :func:`table_token`, so *replacing*
    ``conn.table`` triggers a replan; planning additionally freezes the
    table (``writeable=False``) so *in-place* mutation -- which would
    silently replay the stale plan's residuals -- raises instead.
    Connectivity tables are documented immutable once used."""
    if not config.AFFINE_GATHER or not isinstance(conn.table, np.ndarray):
        return None
    cached = conn.__dict__.get("_affine_plan")
    token = table_token(conn.table)
    if cached is not None and cached[0] == token:
        return cached[1]
    table = conn.table
    if table.ndim == 1:
        table = table[:, None]
    plan = build_table_plan(table, conn.skip_value)
    if plan is not None:
        try:
            conn.table.flags.writeable = False
        except ValueError:
            pass  # view of a foreign buffer: token check still guards
    conn.__dict__["_affine_plan"] = (token, plan)
    return plan


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``x`` with ``lo`` zeros before and ``hi`` after along ``axis``."""
    parts = []
    for n in (lo, hi):
        shape = list(x.shape)
        shape[axis] = n
        parts.append(x.new_zeros(shape))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


def apply_table_plan(plan: TablePlan, data: torch.Tensor, own_start: int, axis: int):
    """Gather ``data`` (codomain on ``axis``) through the planned table.

    Returns the gathered tensor with the codomain axis replaced by
    ``(n, k)`` axes at ``axis`` -- the same layout and values as
    ``index_select(data, axis, clip(table - own_start)).reshape(...)`` --
    or None when the runtime domain does not cover the table's
    non-residual value range (the base path's clip semantics must apply
    instead).  The result never shares memory with ``data``.
    """
    nc = data.shape[axis]
    if plan.vmin - own_start < 0 or plan.vmax - own_start >= nc:
        return None

    # shared pads so every block window slices in bounds: rows whose
    # affine prediction runs past either end are residual by definition
    # (their predicted != stored index), so pad values are never observed
    # -- the index patch overwrites them.  A negative start must be
    # padded: ``narrow`` refuses it.  (A < C blocks issue sub-windows
    # shifted by up to C-1 extra lanes.)
    lpad, rpad = 0, 0
    for cp in plan.cols:
        for blocks in cp.phases:
            for b in blocks:
                extra = b.C - 1 if b.A < b.C else 0
                lpad = max(lpad, -(b.v0 - own_start))
                rpad = max(rpad, (b.v0 - own_start) + extra + b.rows * b.A - nc)
    dpad = _pad_axis(data, axis, lpad, rpad) if (lpad or rpad) else data

    def reshape_axis(x, sizes):
        return x.reshape(x.shape[:axis] + tuple(sizes) + x.shape[axis + 1 :])

    def replay_blocks(blocks):
        pieces = []
        for b in blocks:
            L = b.e1 - b.e0
            R = b.rows
            # overlapping rows (A < C) decompose into ceil(C/A)
            # interleaved non-overlapping windows of width <= A
            if b.A >= b.C:
                sub = [(0, b.C)]
            else:
                sub = [(c0, min(c0 + b.A, b.C)) for c0 in range(0, b.C, b.A)]
            parts = []
            for c0, c1 in sub:
                start = b.v0 - own_start + c0 + lpad
                ww = reshape_axis(dpad.narrow(axis, start, R * b.A), (R, b.A))
                parts.append(ww.narrow(axis + 1, 0, c1 - c0))
            w = parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis + 1)
            w = w.reshape(w.shape[:axis] + (R * b.C,) + w.shape[axis + 2 :])
            if R * b.C != L:
                w = w.narrow(axis, 0, L)
            pieces.append(w)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=axis)

    col_outs = []
    for cp in plan.cols:
        p = len(cp.phases)
        if p == 1:
            out = replay_blocks(cp.phases[0])
        else:
            # interleaved phases: out[x*p + t] = phase_t[x].  Phase
            # lengths differ by <= 1; pad short phases by one row (the pad
            # lands at positions >= n and is sliced away).
            outs = [replay_blocks(blocks) for blocks in cp.phases]
            xm = max(o.shape[axis] for o in outs)
            outs = [o if o.shape[axis] == xm else _pad_axis(o, axis, 0, xm - o.shape[axis])
                    for o in outs]
            inter = torch.stack(outs, dim=axis + 1)
            inter = inter.reshape(inter.shape[:axis] + (xm * p,) + inter.shape[axis + 2 :])
            out = inter.narrow(axis, 0, plan.n)
        if cp.res_pos.size:
            safe = torch.from_numpy(np.clip(cp.res_idx - own_start, 0, nc - 1)).to(data.device)
            vals = torch.index_select(data, axis, safe)
            # out of place: ``out`` may be a view of ``data``
            out = torch.movedim(out, axis, 0).index_put(
                (torch.from_numpy(cp.res_pos).to(data.device),), torch.movedim(vals, axis, 0))
            out = torch.movedim(out, 0, axis)
        col_outs.append(out)
    return torch.stack(col_outs, dim=axis + 1)
