"""Sort-routing gathers for irregular connectivity tables.

The counterpart of ``gt4py_tpu.next.sort_route``.  The affine window
remap (``affine_remap``) covers quasi-structured tables; this module
compiles any other static gather into a few static permutations:

    out[i] = data[idx[i]]        (idx static, N outputs, M sources)

1. **Seed permutation**: route every distinct source value to the first
   output position that wants it (injective, so a permutation after
   padding to a common size P).
2. **Doubling rounds**: positions already holding a value donate it to
   one more position per round; each round's donor -> dest map is one
   more static permutation plus a static select.  ``ceil(log2 L)``
   rounds cover multiplicity ``L``.
3. **Residual patch**: skip values, occurrences beyond the round cap and
   anything outside the planned value window go through the clipped
   ``index_select`` of the base path.

Values are only moved, never recomputed, so the result is bit-identical
to the base path's clipped gather.  The numpy oracle keeps the plain
take; this path engages for torch-backed fields only.

Each static permutation runs through ``benes.permute`` (the K9 kernel on
CUDA tensors, its plain version on CPU tensors); where that declines
(another dtype, rank or size, recorded in ``benes.DECLINES``) it takes
``vals[sigma]``.  The planner's choices -- including the profitability
rule's cost constants -- are the JAX package's, so the same tables plan
the same way on both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config

#: residual fraction above which a plan is rejected
_MAX_RESIDUAL = 0.10
#: tables smaller than this are not worth planning (the gather is fine)
_MIN_SIZE = 65536
#: occurrence-rank cap: ranks >= 2**_MAX_ROUNDS become residual
_MAX_ROUNDS = 3
#: profitability: sort-route only when P*(rounds+1)*S < take_cost*N.  These
#: are the JAX package's cost constants (ns per element per pass), kept so
#: both packages plan alike; they are not times of the H100.  Whether the
#: card should route at all is decided from the times in PERF.md.
_SORT_NS, _TAKE_NS = 1.5, 7.2


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Routing recipe: out_flat = rounds(seed(pad(window(data))))[:N]."""

    n_out: int  # N: flattened table size
    vmin: int  # planned source-value window [vmin, vmax]
    vmax: int
    P: int  # routing size: >= max(N, window)
    #: sort KEY arrays (each a P-permutation): keys[r] = sigma_r^-1, and
    #: the round moves dest[j] = src[sigma_r(j)]
    keys: Tuple[np.ndarray, ...]
    #: per round r >= 1: bool (P,) -- positions receiving a copy
    masks: Tuple[np.ndarray, ...]
    res_pos: np.ndarray  # positions handled by the index patch
    res_idx: np.ndarray  # raw table values at those positions
    #: device tensors derived from the arrays above, per device
    _device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def on(self, device) -> dict:
        """The plan's masks, residual positions and inverse keys as tensors
        on ``device`` (made once per device)."""
        t = self._device.get(device)
        if t is None:
            t = {
                "masks": [torch.from_numpy(m).to(device) for m in self.masks],
                "res_pos": torch.from_numpy(self.res_pos).to(device),
                "sigma": [None] * len(self.keys),
            }
            self._device[device] = t
        return t


def build_gather_plan(table: np.ndarray, skip_value: Optional[int]) -> Optional[GatherPlan]:
    """Plan a (possibly multi-column) neighbor table; None when the plain
    gather is the better choice (small or ultra-hub tables)."""
    table = np.asarray(table)
    if table.size < _MIN_SIZE:
        return None
    idx = table.reshape(-1).astype(np.int64)
    N = idx.size
    good = np.ones(N, dtype=bool)
    if skip_value is not None:
        good &= idx != skip_value
    if not good.any():
        return None
    vmin = int(idx[good].min())
    vmax = int(idx[good].max())
    W = vmax - vmin + 1
    P = max(N, W)

    # group positions by source slot; rank = occurrence index within slot
    slots = np.where(good, idx - vmin, -1)
    order = np.argsort(slots, kind="stable")  # residuals (-1) first
    n_bad = int(N - good.sum())
    pos_sorted = order[n_bad:]  # positions grouped by slot, ascending
    slot_sorted = slots[pos_sorted]
    first = np.ones(pos_sorted.size, dtype=bool)
    first[1:] = slot_sorted[1:] != slot_sorted[:-1]
    grp_start = np.flatnonzero(first)
    rank = np.arange(pos_sorted.size) - np.repeat(
        grp_start, np.diff(np.append(grp_start, pos_sorted.size))
    )

    cap = 1 << _MAX_ROUNDS
    over = rank >= cap
    res_mask = ~good
    res_mask[pos_sorted[over]] = True
    if res_mask.sum() > _MAX_RESIDUAL * N:
        return None
    L = int(rank[~over].max()) + 1 if (~over).any() else 1
    rounds = max(0, (L - 1).bit_length())

    if _SORT_NS * P * (rounds + 1) >= _TAKE_NS * N:
        return None

    def complete(partial_dest_to_src: np.ndarray) -> np.ndarray:
        """Fill -1 entries to a full P-permutation (unused sources onto
        unassigned destinations, in order)."""
        used = np.zeros(P, dtype=bool)
        assigned = partial_dest_to_src >= 0
        used[partial_dest_to_src[assigned]] = True
        out = partial_dest_to_src.copy()
        out[np.flatnonzero(~assigned)] = np.flatnonzero(~used)
        return out

    def keys_for(dest_to_src: np.ndarray) -> np.ndarray:
        """key[s] = sigma^-1(s) for dest[j] = src[sigma(j)]."""
        inv = np.empty(P, dtype=np.int64)
        inv[dest_to_src] = np.arange(P)
        return inv.astype(np.int32)

    keys = []
    masks = []
    seed = np.full(P, -1, dtype=np.int64)
    r0 = rank == 0
    seed[pos_sorted[r0]] = slot_sorted[r0]
    keys.append(keys_for(complete(seed)))

    for r in range(1, rounds + 1):
        half = 1 << (r - 1)
        sel = (rank >= half) & (rank < 2 * half) & ~over
        dests = pos_sorted[sel]
        # donor = same slot, rank - half: pos_sorted is rank-ordered
        # within each slot, so the donor sits `half` entries earlier
        donors = pos_sorted[np.flatnonzero(sel) - half]
        sigma = np.full(P, -1, dtype=np.int64)
        sigma[dests] = donors
        keys.append(keys_for(complete(sigma)))
        m = np.zeros(P, dtype=bool)
        m[dests] = True
        masks.append(m)

    res_pos = np.flatnonzero(res_mask).astype(np.int64)
    return GatherPlan(
        n_out=N,
        vmin=vmin,
        vmax=vmax,
        P=P,
        keys=tuple(keys),
        masks=tuple(masks),
        res_pos=res_pos,
        res_idx=idx[res_pos].copy(),
    )


def plan_for(conn) -> Optional[GatherPlan]:
    """Cached gather plan for an irregular Connectivity (None when
    ``config.SORT_GATHER`` is off, or the plain gather or the affine remap
    should be used).  Cache keying and the immutability freeze follow
    ``affine_remap.plan_for``."""
    if not config.SORT_GATHER or not isinstance(conn.table, np.ndarray):
        return None
    from . import affine_remap

    cached = conn.__dict__.get("_sort_route_plan")
    token = affine_remap.table_token(conn.table)
    if cached is not None and cached[0] == token:
        return cached[1]
    plan = build_gather_plan(conn.table, conn.skip_value)
    if plan is not None:
        try:
            conn.table.flags.writeable = False
        except ValueError:
            pass
    conn.__dict__["_sort_route_plan"] = (token, plan)
    return plan


def _permute(vals: torch.Tensor, plan: GatherPlan, r: int) -> torch.Tensor:
    """Round ``r``'s static permutation of a 1-D tensor: ``benes.permute``,
    or ``vals[sigma]`` where it declines."""
    from . import benes

    out = benes.permute(vals, plan.keys[r])
    if out is not None:
        return out
    dev = plan.on(vals.device)
    if dev["sigma"][r] is None:
        dev["sigma"][r] = torch.from_numpy(np.argsort(plan.keys[r], kind="stable")).to(vals.device)
    return vals[dev["sigma"][r]]


def apply_gather_plan(plan: GatherPlan, data: torch.Tensor, own_start: int, axis: int):
    """Gather ``data`` through the planned table: the same layout and
    values as ``index_select(data, axis, clip(table - own_start))`` (flat;
    the caller reshapes to the table's shape).  None when the runtime
    domain does not cover the planned value window (the base path's clip
    semantics must apply)."""
    nc = data.shape[axis]
    if plan.vmin - own_start < 0 or plan.vmax - own_start >= nc:
        return None
    dev = plan.on(data.device)

    # flatten the non-gather axes: route along a leading axis
    moved = torch.movedim(data, axis, 0)
    rest = moved.shape[1:]
    flat = moved.reshape(moved.shape[0], -1)

    lo = plan.vmin - own_start
    win = flat[lo : lo + (plan.vmax - plan.vmin + 1)]
    if win.shape[0] < plan.P:
        win = torch.cat([win, win.new_zeros((plan.P - win.shape[0], win.shape[1]))])

    def route(col):
        cur = _permute(col, plan, 0)
        for r, mask in enumerate(dev["masks"], start=1):
            cur = torch.where(mask, _permute(cur, plan, r), cur)
        return cur[: plan.n_out]

    out_flat = torch.stack([route(win[:, c].contiguous()) for c in range(win.shape[1])], dim=1)

    if plan.res_pos.size:
        safe = dev.get(("safe", own_start, nc))
        if safe is None:
            safe = torch.from_numpy(np.clip(plan.res_idx - own_start, 0, nc - 1)).to(data.device)
            dev[("safe", own_start, nc)] = safe
        out_flat[dev["res_pos"]] = torch.index_select(flat, 0, safe)

    out = out_flat.reshape((plan.n_out,) + tuple(rest))
    return torch.movedim(out, 0, axis)
