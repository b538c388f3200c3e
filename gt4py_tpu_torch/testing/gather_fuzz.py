"""Randomized differential fuzz for the sort-routing gather planner
(:mod:`gt4py_tpu_torch.next.sort_route`) and chain folding.

The counterpart of ``gt4py_tpu.testing.gather_fuzz``, with the same draws
per seed.  ``run_gather_case`` draws a table family (uniform, hub-heavy,
near-permutation, narrow-window, corrupted-affine), optional skip values,
a data dtype (f32 or raw i32 bit patterns), a gather axis and an
``own_start`` offset, then checks ``apply_gather_plan`` -- on the card its
permutes run K9 (``next/benes.py``) -- BIT FOR BIT against the index path
(the clipped ``take`` it must reproduce; values are only moved, never
recomputed).  ``run_chain_case`` checks ``premap(c1, c2)`` bit for bit
against ``remap(c1).remap(c2)``.  A plan that declines is a valid
outcome.  Both take a ``device`` and return ``(outcome, launches)``:
``launches`` counts the permutes that ran K9 (``benes.KERNEL.launches``;
0 on the CPU, where the plain butterfly runs).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gt4py_tpu_torch.next import benes
from gt4py_tpu_torch.next import common as C
from gt4py_tpu_torch.next import sort_route as sr


def run_gather_case(seed: int, device="cpu") -> Tuple[str, int]:
    """One differential case; the outcome is 'declined', 'routed', or
    'no-window' (the runtime domain does not cover the planned window:
    apply must return None, the caller takes the index path)."""
    rng = np.random.default_rng(seed)
    fam = int(rng.integers(0, 5))
    N = int(rng.integers(66000, 140000))
    M = int(rng.integers(2000, 200000))
    if fam == 0:  # uniform
        t = rng.integers(0, M, N)
    elif fam == 1:  # hub-heavy: most entries hit a handful of values
        hubs = rng.integers(0, M, 8)
        hot = rng.random(N) < 0.8
        t = np.where(hot, hubs[rng.integers(0, 8, N)], rng.integers(0, M, N))
    elif fam == 2:  # near-permutation (every source about equally often)
        reps = -(-N // M)
        t = rng.permutation(np.tile(np.arange(M), reps)[:N])
    elif fam == 3:  # narrow value window away from zero
        c = int(rng.integers(0, M))
        W = int(rng.integers(256, max(257, M // 2)))
        t = c + rng.integers(0, W, N)
        M = max(M, c + W + 1)
    else:  # affine-structured with random corruption
        stride = int(rng.integers(1, 7))
        t = (np.arange(N, dtype=np.int64) * stride) % M
        k = N // 7
        t[rng.integers(0, N, k)] = rng.integers(0, M, k)
    t = t.astype(np.int64)
    skip = None
    if rng.random() < 0.4:
        skip = -1
        t[rng.random(N) < 0.03] = skip
    # sometimes a multi-column (neighbor-table) shape
    if rng.random() < 0.5:
        ncol = int(rng.integers(2, 5))
        t = t[: (N // ncol) * ncol].reshape(-1, ncol)
    plan = sr.build_gather_plan(t, skip)
    if plan is None:
        return "declined", 0
    flat = t.reshape(-1)
    own_start, nc = 0, M
    if plan.vmin > 0 and rng.random() < 0.5:
        # shard-local source numbering: data holds [own_start, own_start+nc)
        own_start = int(rng.integers(0, plan.vmin + 1))
        nc = M - own_start
    if rng.random() < 0.1:
        # deliberately non-covering domain: apply must refuse
        nc = max(1, plan.vmax - own_start - int(rng.integers(1, 64)))
    if rng.random() < 0.5:
        data = rng.random(nc).astype(np.float32)
    else:
        data = rng.integers(0, 2 ** 32, nc, dtype=np.uint64).astype(np.uint32).view(np.int32)
    axis = 0
    if rng.random() < 0.3:  # extra axes around the gather axis
        data = np.stack([data, data[::-1].copy()], axis=-1)
    if rng.random() < 0.3:
        data = np.stack([data] * 2, axis=0)
        axis = 1
    before = benes.KERNEL.launches
    got = sr.apply_gather_plan(plan, torch.from_numpy(data).to(device), own_start, axis)
    launches = benes.KERNEL.launches - before
    if not (plan.vmin - own_start >= 0 and plan.vmax - own_start < data.shape[axis]):
        assert got is None, "apply must decline non-covering domains"
        return "no-window", launches
    ref = np.take(data, np.clip(flat - own_start, 0, data.shape[axis] - 1), axis=axis)
    np.testing.assert_array_equal(got.cpu().numpy(), ref, err_msg=f"seed {seed}")
    return "routed", launches


def run_chain_case(seed: int, device="cpu") -> Tuple[str, int]:
    """Multi-hop composition (``common._maybe_compose`` + offset-chain
    folding): a random two-hop chain through random-family tables must
    make ``premap(c1, c2)`` bit for bit equal to ``remap(c1).remap(c2)``;
    the outcome is 'composed' or 'sequential' (the cost guard declining is
    valid; both paths must still agree)."""
    rng = np.random.default_rng(seed)
    A, B, Cd = C.Dimension("ChA"), C.Dimension("ChB"), C.Dimension("ChC")
    L = C.Dimension("ChL", kind=C.DimensionKind.LOCAL)
    n0 = int(rng.integers(3000, 30000))   # data codomain size
    n1 = int(rng.integers(3000, 30000))   # intermediate size
    n2 = int(rng.integers(3000, 30000))   # final size

    def make_col(n, m):
        fam = int(rng.integers(0, 3))
        if fam == 0:  # uniform random (irregular)
            return rng.integers(0, m, n)
        if fam == 1:  # affine-structured
            stride = int(rng.integers(1, 5))
            return (np.arange(n, dtype=np.int64) * stride) % m
        c = int(rng.integers(0, m))  # narrow window
        W = int(rng.integers(64, max(65, m // 2)))
        return np.clip(c + rng.integers(0, W, n), 0, m - 1)

    if rng.random() < 0.4:  # 2D first hop (neighbor table)
        k1 = int(rng.integers(2, 4))
        t1 = np.stack([make_col(n1, n0) for _ in range(k1)], axis=1)
        local = L
    else:
        t1 = make_col(n1, n0)
        local = None
    t2 = make_col(n2, n1)
    skip1 = None
    if rng.random() < 0.3:
        skip1 = -1
        t1 = t1.copy()
        t1[rng.random(t1.shape) < 0.02] = skip1
    if rng.random() < 0.3:
        t2 = t2.copy()
        t2[rng.random(t2.shape) < 0.02] = -1  # clips in both paths
    conn1 = C.Connectivity(t1.astype(np.int64), source=B, codomain=A, local_dim=local,
                           skip_value=skip1)
    conn2 = C.Connectivity(t2.astype(np.int64), source=Cd, codomain=B, skip_value=None)
    own_start = int(rng.integers(-3, 4))
    if rng.random() < 0.5:
        data = rng.random(n0).astype(np.float32)
    else:
        data = rng.integers(0, 2 ** 32, n0, dtype=np.uint64).astype(np.uint32).view(np.int32)
    f = C.Field(C.Domain((A,), (C.UnitRange(own_start, own_start + n0),)),
                torch.from_numpy(data).to(device))
    before = benes.KERNEL.launches
    seq = f.remap(conn1).remap(conn2)
    one = f.premap(conn1, conn2)
    launches = benes.KERNEL.launches - before
    assert tuple(d.value for d in one.dims) == tuple(d.value for d in seq.dims), f"seed {seed}"
    np.testing.assert_array_equal(one.data.cpu().numpy(), seq.data.cpu().numpy(),
                                  err_msg=f"seed {seed}")
    cache = conn2.__dict__.get("_compose_cache") or {}
    return ("composed" if any(v is not None for v in cache.values()) else "sequential",
            launches)
