#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: the FullDycore step on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --tiles`` runs phase 12 alone, ``--tile-sweep``
the tile form's tiles and levels a CTA (``TILE_SWEEP``) on hdiff, fv_step
and sw_step, each timed and bitwise against plain.

``python3 chip_smoke.py --k6-k5`` runs the tile kernels on tight and
aligned buffers (``_tight_tiles``: device time, staging, registers), the
fused MiniDycore stencil in its sweep, plane-sweep and split forms with
back-to-back pairs (``_sweep_pairs``) and the sweep at each tile of
``SWEEP_TILE_SWEEP``; ``--k6-k5 tight`` the first alone (it also runs
against an older tree's package, with this script copied there).

``python3 chip_smoke.py --k3`` runs the K3 phase alone (``_k3``,
``_k3_library``; it also runs against an older tree's package, with this
script copied there), ``--k3-tiles`` the staged kernel of
``variable_k_offset`` at each CTA shape of ``K3_TILES``.

``python3 chip_smoke.py --fuzz`` runs phase 14 alone (the differential
fuzzers, their builds included).

``python3 chip_smoke.py --examples`` runs phase 16 alone (the examples).

``python3 chip_smoke.py --dist`` runs phase 15 alone (the distribution
layer on gloo ranks sharing the card, its three builds included).

``python3 chip_smoke.py --profile-check`` profiles a 16 MiB add (one kernel
a call) and a K9 permute of 2^20 words (three a call) ``PROFILE_AGE_S``
seconds after a first profile, with and without a warm-up cycle and idle
time at the profile's ends (``PROFILE_VARIANTS``), and prints, per
variant, the device events seen against the launches made and where the
add's kernels start against their launches.

``python3 chip_smoke.py --k9-layouts`` runs only the sweep that chose
``benes.layout``: K9's device time at the FVM's two permute sizes in each
layout of ``K9_LAYOUTS`` (inner block 2^b, outer row segment 2^c) with 8
and 16 registers a thread, each result bitwise equal to ``x[sigma]``.

Phases (a failed phase raises, and the script exits non-zero):

1. require a CUDA device; print the torch, CUDA and nvcc versions and the
   card's name and power limit;
2. build every generated CUDA kernel the later phases launch from the
   repository's sources (one nvcc per stencil, all started together,
   sm_90a), phase 10's plane-sweep and K-blocked ones included, and print
   the build seconds and ptxas' report;
3. kernel against plain on the card: ``backend="cuda"`` against
   ``backend="torch"`` for hdiff, vadv_update and dycore_fused, periodic,
   at 512x512x80 float32 and 64x256x16 float64;
4. the MiniDycore path: ``MiniDycore(512, 512, 80, float32, backend="cuda")``,
   10 steps of ``step_fn()`` and of ``step_fn(fused=True)``, with the launch
   counts of every kernel read around that run, the state checked finite
   and against the plain executor, and both forms timed with CUDA events;
   the fused step runs its default form (``cuda_backend.SERIALIZE_MIXED``:
   the split build, tile and fused column kernels; asserted from
   ``LAST_PLAN`` and the library's launch counts), equal bit for bit over
   10 steps to the split build and to plain, each timed one call at a
   time and back to back; then K5's path: 10 fused steps built
   ``sweep=True`` (one sweep kernel a call, counted by its library),
   bitwise against the default form and plain, and the sweep, plane-sweep
   and split forms' device times and back-to-back pairs (the pairs behind
   ``SERIALIZE_MIXED``);
5. the language surface: every canonical stencil with ``while``, regions,
   variable K or data dimensions (``tests/cartesian/stencil_defs.py``) and
   the ``.at(K=...)`` forms (``gt4py_tpu_torch.testing.SURFACE``), in
   float64, each launched once with its count read around that run and its
   result held against the plain executor; one stencil per feature timed
   at 512x512x80; then the K3 phase: ``variable_k_offset`` at 512x512x80
   float64 with offsets in [-3, 3] and over the whole column ([-80, 80]),
   ``at_k_field``, ``variable_k_in_scan`` and ``at_k_in_scan``, each
   bitwise against plain, the staged form against ``stage_vark=False`` in
   device-time turns (parent, staged, staged, parent), with the launches
   its library counts, the reads outside its windows and the bound; and
   the PyTorch calls that compute K3's and K7's functions
   (``torch.gather``), their times the two entries' ``library_ms``;
6. the FullDycore path: ``FullDycore(512, 512, 80, float32, backend="cuda")``:
   fv_step and sl_step singly against plain (and at 64x256x16 float64),
   then 10 steps with the launch counts of every stencil read around them,
   ``u``, ``q`` and ``qsl`` checked finite and against 10 plain steps, then
   the steps timed with CUDA events, one call at a time and back to back;
7. the next DSL (``gt4py_tpu_torch.next``) at 512x512x80 float32 and
   64x256x16 float64, bench.py's configurations and geometry: the hdiff
   field operator with ``out=``/``domain=``, the four-statement hdiff
   program and the lap -> scan -> update program, each fused and
   statement-wise (``config.PROGRAM_FUSION``), and the tridiagonal scans
   with a tuple carry.  Each runs ``with_backend("cuda")`` against the
   embedded ``with_backend("torch")`` on the card, with every kernel's
   launch count read around the run and ``cuda_bridge.FALLBACK_EVENTS``
   unchanged across the phase; then each is timed (CUDA events, one call
   at a time and 20 back to back; the host's enqueue time per call), and
   hdiff once more on K-contiguous fields;
8. the unstructured gather path: the K9 kernel (``next/benes.py``,
   ``csrc/benes.cu``: three launches, each CTA's words in registers)
   on raw permutations (P = 2^17, 2^17 + 311, 2^20 and 2^24 in float32,
   2^17 in int32 with NaN-aliasing patterns) against its plain version and
   ``x[sigma]``, bit for bit, with its kernel launches per permute counted
   by the library (``benes.KERNEL.device_launches``);
   bench.py's unstructured FVM step
   at n = 512 float32 on ``grid_mesh`` (affine windows) and
   ``shuffled_mesh(512, 7)`` (sort-routed, K9), 10 steps with the
   planners on against 10 on the index path (``config.AFFINE_GATHER =
   config.SORT_GATHER = False``), bit for bit, with K9's launches read
   around the irregular run (the permutes and the library's kernel
   launches); CUDA-event times of the step (one call at a time, 20 back
   to back, the host's enqueue time), of K9 per permute against
   ``torch.index_select`` of the same permutation and its bound (one call
   at a time, and device time and kernel launches from
   ``torch.profiler``), and a ``torch.profiler`` breakdown of the
   irregular step; then one
   MiniDycore and one FvAdvection step in bfloat16 at 512x512x80 against
   plain (phase 5 also runs the bfloat16 stencil);
9. gradients (K8, ``gt4py_tpu_torch/cartesian/backend/autodiff.py``): the
   FullDycore step at 512x512x80 float32, loss the sum of squares of u, q
   and qsl, its gradient with respect to the initial u and q by
   ``torch.autograd.grad`` with the forward on the kernels (the launches
   and K8 engagements of every forward stencil read around the run),
   against the gradient of ``backend="torch"`` on the card, finite and
   nonzero; the forward and forward + backward times of both, the
   backward's share and peak device memory; ``torch.func.jvp`` of the
   MiniDycore step against the plain one; at 64x256x16 float64 the
   gradient against plain and its directional derivative against central
   differences; the sort-routed FVM energy's gradient at n = 512 float32,
   K9 launched once per forward permute and once per backward one, against
   the index path; ``torch.func.grad`` and ``torch.func.vjp`` of the
   MiniDycore step loss against ``torch.autograd.grad``;
10. plan modes: (a) fault 1's loop (a FORWARD loop reading ``t[1, 0, 0]``
   of the ``t`` it writes), a K-carried temporary read at offsets, reads
   of values the sweep has not written yet in the plane-sweep form, and
   the mixed stencils of ``tests/cartesian/test_serialize_parallel.py``
   in the sweep form (``sweep=True``, K5) and in the plane-sweep form
   (``serialize=True``), float64 at 64x256x16, bounded and periodic, bit
   for bit against plain; (b) the deep-K MiniDycore step at 128x128x2048
   float32: 10 steps with ``vadv_update`` K-blocked (K4: one launch per
   column loop over a ring of shared-memory slots, the launches counted
   by the stencil's library; its KB, slots, shared bytes and CTAs per SM
   read from ``LAST_PLAN``, its registers from ptxas) against 10 steps of
   the one-pass build (``k_blocked=False``) and 10 plain ones, bit for
   bit, and both forms timed one call at a time and in three back-to-back
   pairs, with K4's plain counterpart (the blocks through the plain
   executor); K4 at 512x512x80 float32 against one pass, bit for bit and
   timed, for the record; vadv_update K4 against one pass at 128x128 and
   depths 80 to 1024, and at wider domains (``WIDE``), bit for bit and in
   back-to-back pairs, each checking the default build's choice
   (``cuda_backend.kb_default``); (c) fv_step at
   512x512x80 float32 built with
   ``serialize=True`` (its 13 row stages as one plane-sweep kernel)
   against the tile form, bit for bit and timed in turns;
11. (K6) the geometry-repair shapes (no copy by default), ShallowWater, the
   tight-halo steps by default (row-phase staging) and repaired
   (``repair=True``), the tile kernels' device time on tight against
   aligned buffers beside the parent's element-copy times, the vector and
   scalar forms in turns;
12. the tile form (K1) and the fused column kernel (K2): hdiff, fv_step,
   sw_step, sl_step (its tile form forced: one stage runs the row kernel
   by default), vadv_update and dycore_fused at 512x512x80 float32 and
   64x256x16 float64, periodic and bounded, each against its split build
   (``tiles=False`` / ``fuse_loops=False``) and plain bit for bit, its
   forms from ``LAST_PLAN`` and its kernel launches counted by its library
   (1 a call, dycore_fused 2); each timed one call at a time and in three
   back-to-back pairs against the split build, with device time per kernel
   from ``torch.profiler`` (which must show every launch the library
   counts); the FullDycore step's device time by kernel, with its
   stencils' default forms;
13. the ``--profile-check`` profiles again, at the end of a long process;
14. the differential fuzzers (``--fuzz`` alone): every program of
   ``gt4py_tpu_torch.testing.program_gen.LEGS`` (random stencils of the
   JAX package's generator: the JAX fuzzer's C-order arrays, the models'
   (K, I, J) buffers aligned and tight, periodic, 37x70x23, 8x8x600,
   serialized builds, float32 and bfloat16) on ``"cuda"`` against
   ``"torch"`` on the card and both against the numpy oracle, each
   program's kernels counted by its library; the next DSL's operator,
   program and bridge fuzz on ``"cuda"`` against embedded torch and the
   oracle (operators the bridge declines counted); the gather and chain
   fuzz, K9 against the index path bit for bit.  The phase prints each
   leg's launches by form and fails where it reached no tile, fused
   column, staged variable-K or K-blocked kernel, no row-phase or element
   staging or no periodic call (``FUZZ_COVERAGE``), and on a declined
   program not pinned in ``program_gen.LEG_DECLINES``.  Every launch count
   is its library's: each stencil's by kernel, summed by form and held to
   its total.  The two forms only fuzz programs reach (a launch a level,
   the CTA-iterated ``while``) are timed at 512x512x80 against plain
   (``FUZZ_TIMED``).  Its builds start with phase 2's.  The base leg holds
   seeds 147, 199 and 386, the programs the kernels once declined (a
   ``while`` iterated by the CTA after a writer the plane form widens, and
   one in the tile form);
15. distribution (``--dist`` alone; ``_distribution``): ``DIST_RANKS``
   gloo ranks sharing the one card as a 2x2 mesh (``torch.multiprocessing``,
   spawned, a file store; ``torch.cuda.empty_cache()`` first), the bench
   size 512x512x80 float32 split into 256x256x80 blocks, periodic
   (``testing.dist_cases.chip_distribution``): 3 sharded MiniDycore steps
   (``shard_map_stencil`` over ``step_fn(fill_halos=False)``) with each
   rank's hdiff and vadv_update launches read from their libraries around
   its run, the gathered ``u`` and ``utens_stage`` against 3 single-device
   periodic steps on the card; the overlapped step
   (``overlapped_shard_map_stencil`` over ``region_step_factory``) against
   it; one sharded FvAdvection step against the single-device one, tracer
   mass to 1e-4; a bfloat16 wire (half the bytes, the exchange staged
   through host memory, each rank's exchanged blocks equal bit for bit to
   the float32 exchange's with every received strip cast to bfloat16 and
   back by ``core.dtypes.cast``); each rank's step, overlapped step, exchange (float32 and
   bfloat16 wire) and kernel times (CUDA events, median of 10) printed
   beside the card's name and power limit; then the global view on the
   kernels: the JAX package's GSPMD fuzz seeds 11000-11005 (float64,
   regions in the global frame, ``while``, variable K) on ``"cuda"`` on
   DistributedFields, each rank's launches counted by the library,
   against the plain executor's single-device run; then the phased calls
   (``testing.dist_cases.chip_phased``, in the same launch): the ring
   stencil at 512x512x80 float64 (256x256x80 blocks; one level at a time,
   ``t`` exchanged between levels) and the generated programs 11203 (a
   ``while`` iterated across the ranks) and 11238 (a BACKWARD loop a level
   at a time) on ``"cuda"`` on DistributedFields, every phase's kernels
   counted by its library on every rank, each bit for bit the
   single-device ``"cuda"`` run, with its exchanges and CUDA-event times
   beside the single-device time.  A failing rank fails the phase;
16. the examples (``--examples`` alone; ``_examples``): every module of
   ``gt4py_tpu_torch.examples`` as its command, each its own process, all
   started together; each must exit 0 on the card and launch CUDA kernels
   (``torch.profiler``'s count), the two with a ``"cuda"`` path also
   kernels its libraries counted; each one's seconds printed.

Every kernel entry carries ``bound_ms``: the least time the card could take
for the same function, its bytes (each input read once, each output written
once) over 3.35 TB/s, the H100 SXM's memory rate (the stencils and K9 do a
few operations per byte, so bytes bound them), and ``library_ms``, the time
of one PyTorch call that computes the same function where there is one
(``torch.index_select`` for K9, ``torch.gather`` for K3 and K7, none for
the other stencils).  K8's entry is the
FullDycore step's gradient: its launches are the calls that ran under K8,
its bound the bytes of those calls' inputs, cotangents and input gradients.
The line before the last is one JSON object with every kernel's launches,
error and times and phases 8 and 9's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

#: f64 kernel vs plain: allows for FMA contraction (the kernels build with
#: --fmad=false; measured on an H100 the difference is 0, see PERF.md)
RTOL_F64 = 1e-11
ATOL_F64 = 1e-13
#: f32 kernel vs plain: measured on an H100 the difference is 0 (every
#: operation rounds as in the plain version); the bound leaves a few ulp
RTOL_F32 = 1e-6
ATOL_F32 = 1e-7
#: f32 gradient on the adjoint kernels vs the plain backward: the gathers
#: add each point's terms in another order than autograd's scatter, and
#: entries are sums of terms of both signs, so the bound is relative to the
#: largest entry: measured on an H100 80GB HBM3 at 700 W (``--k8``), 9.537e-07
#: at most for entries up to about 4.4, a few ulp of the largest
GRAD_RTOL_F32 = 1e-5
GRAD_ATOL_F32 = 1e-6

STEPS = 10
TIMING_REPS = 20
#: the H100 SXM's device-memory rate (bytes per second), for ``bound_ms``
HBM_BYTES_PER_S = 3.35e12
#: phase 8: bench.py's unstructured FVM size and K9's raw permutations
FVM_N = 512
K9_RAW = [(1 << 17, "float32"), ((1 << 17) + 311, "float32"), (1 << 20, "float32"),
          (1 << 24, "float32"), (1 << 17, "int32")]
#: ``--k9-layouts``: the FVM's permute sizes at n = 512 (E2V columns,
#: V2E), and the layouts (b, c) timed at each with 2^e registers a thread
K9_LAYOUT_SIZES = (523264, 1 << 20)
K9_LAYOUTS = [(10, 3), (11, 3), (11, 4), (12, 3), (12, 4), (13, 3), (13, 4)]
K9_REG_LOG2 = (3, 4)
#: the JAX package's chip test's NaN/Inf/sign bit patterns (int32 leg)
NAN_PATTERNS = [0x7F800001, 0x7FC00000, 0x7F800000, 0xFF800000, 0x80000000, 0xFFFFFFFF]
PLAIN_TIMING_REPS = 3
#: each profile first runs its calls as the profiler's warm-up cycle (its
#: events discarded), and stays open, idle, for ``PROFILE_PAD_S`` seconds
#: before and after the calls (their device work synchronized first).
#: Without the warm-up, profiles taken minutes into a process lost device
#: events of their first calls, idle time or not; without the idle time,
#: kernels timestamped up to 2.6 ms before their launches fell outside the
#: profile (``--profile-check``, PERF.md)
PROFILE_WARMUP = True
PROFILE_PAD_S = 0.05
T_START = time.time()
BACK_TO_BACK = 20
NI, NJ, NK = 512, 512, 80
SMALL = (64, 256, 16)
#: phase 10 (b): the deep-K MiniDycore (K4), and the depths at which K4
#: and one pass are timed against each other at 128 x 128 (K4's default
#: threshold, ``cuda_backend.KB_DEFAULT_DEPTH``, comes from these runs)
DEEP = (128, 128, 2048)
DEPTHS = (80, 128, 256, 512, 1024)
#: phase 10 (b): wider deep domains, where one pass already fills the card
#: (512 x 512 at most 1024 levels: at 2048 the card ran out of memory
#: beside what the earlier phases hold)
WIDE = ((256, 256, 512), (512, 512, 512), (256, 256, 2048), (512, 512, 1024))
#: phase 11 (a): the shapes of tests/cartesian/test_geometry_repair.py:
#: stencil -> ({field: (I, J, K) buffer shape}, origins, domain)
_ZERO = (0, 0, 0)
REPAIR_SHAPES = {
    "outop": ({"inp": (16, 256, 4), "coeff": (16, 256, 4), "fx": (17, 256, 4),
               "fy": (16, 257, 4), "res": (16, 256, 4)},
              {"inp": _ZERO, "coeff": _ZERO, "fx": (1, 0, 0), "fy": (0, 1, 0), "res": _ZERO},
              (16, 256, 4)),
    "lapd": ({"a": (12, 132, 4), "b": (14, 140, 4)}, {"a": (1, 1, 0), "b": (2, 3, 0)},
             (10, 130, 4)),
    "serk": ({"a": (10, 130, 5), "b": (10, 130, 5)}, {"a": _ZERO, "b": _ZERO}, (10, 130, 5)),
    "while_loop": ({"a": (10, 130, 4), "b": (10, 130, 4)}, {"a": _ZERO, "b": _ZERO},
                   (10, 130, 4)),
    "region_end": ({"a": (33, 228, 2), "b": (33, 228, 2)}, {"a": _ZERO, "b": _ZERO},
                   (33, 228, 2)),
}

#: phase 11 (a): the item sizes at which a shape's fields share no 16-byte
#: phase in the (K, I, J) layout (its row stages run the scalar kernels):
#: outop's fy has rows of 257 items; lapd's a and b start on different
#: float32 phases; while_loop's rows of 130 float32 are 520 bytes
REPAIR_NO_PHASE_KIJ = {"outop": {4, 8}, "lapd": {4}, "while_loop": {4}}

#: phase 5: the canonical stencils by the feature the kernels take over
#: from the TPU path (REPLACES key), and one of each timed at full size
SURFACE_FEATURES = {
    "vark": ["variable_k_offset", "at_k_literal", "at_k_scalar", "at_k_field",
             "at_k_in_scan", "variable_k_in_scan", "variable_k_after_write"],
    "data_dims": ["data_dims_dynamic_index", "data_dims_norm", "region_data_dims_interaction",
                  "while_data_dims_interaction", "data_dims_writes", "data_dims_dynamic_write"],
    "while": ["while_halving", "while_backward", "region_while_interaction"],
    "regions": ["horizontal_regions", "region_with_conditional"],
    "float16": ["float16_hdiff_sweep"],
    "bfloat16": ["bfloat16_hdiff_sweep"],
}
SURFACE_TIMED = {"vark": "variable_k_offset", "data_dims": "data_dims_dynamic_index",
                 "while": "while_halving", "regions": "horizontal_regions",
                 "float16": "float16_hdiff_sweep", "bfloat16": "bfloat16_hdiff_sweep"}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _errors(got, ref):
    d = (got.double() - ref.double()).abs()
    rel = d / ref.double().abs().clamp_min(1e-30)
    return float(d.max()), float(rel.max())


def _check_close(what, got, ref, rtol, atol):
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if got.dtype.is_floating_point and not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    ok = torch.isclose(got, ref, rtol=rtol, atol=atol)
    if not bool(ok.all()):
        abs_err, rel_err = _errors(got, ref)
        raise AssertionError(
            f"{what}: kernel and plain disagree (max abs {abs_err:.3e}, max rel "
            f"{rel_err:.3e}; rtol {rtol}, atol {atol})"
        )
    return _errors(got, ref)


def _time_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between two
    CUDA events (the card's clock), after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _time_chain_ms(step, state, n):
    """Milliseconds per step of ``n`` steps enqueued back to back, each on
    the last one's output, between two CUDA events."""
    import torch

    state = step(step(state))  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        state = step(state)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _ptxas(st, build_dir=None) -> str:
    """ptxas' registers and spill stores of a stencil's kernels (or of the
    build in ``build_dir``)."""
    log = open(os.path.join(build_dir or st.backend.build_dir, "build.log")).read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    return f"registers {regs}, spill stores {spills}"


def _stencil_calls(md, state, diffused):
    """The three MiniDycore stencils' periodic calls on ``state`` as the
    steps make them (``diffused``: hdiff's output, vadv_update's input):
    name -> (stencil object, zero-argument call)."""
    return {
        "hdiff": (md.hdiff, lambda: md.hdiff_fn_p(
            in_field=state["u"], out_field=state["u"], coeff=state["coeff"])),
        "vadv_update": (md.vadv_upd, lambda: md.vadv_upd_fn_p(
            utens_stage=state["utens_stage"], u_stage=diffused, wcon=state["wcon"],
            u_pos=diffused, utens=state["utens"], u_out=state["u"], dtr_stage=3.0)),
        "dycore_fused": (md.fused, lambda: md.fused_fn_p(
            u=state["u"], coeff=state["coeff"], wcon=state["wcon"], utens=state["utens"],
            utens_stage=state["utens_stage"], u_out=state["u"], dtr_stage=3.0)),
    }


def _fv_calls(fd, state):
    """The FullDycore's two new stencils, called as its step calls them."""
    import torch

    fv_fn = fd.fv.fns["step_p"]
    return {
        "fv_step": (fd.fv.fv_step, lambda: fv_fn(
            q=state["q"], cx=state["cx"], cy=state["cy"],
            qout=torch.zeros_like(state["q"]))),
        "sl_step": (fd.sl, lambda: fd.sl_fn(
            q=state["qsl"], u=state["cx"], v=state["cy"],
            qout=torch.zeros_like(state["qsl"]), dtdx=1.0, dtdy=1.0)),
    }


def _scaled_inputs(make_inputs, shape, device):
    """``make_inputs()``'s fields redrawn at ``shape`` (plus their data
    dims) over the same value ranges and dtypes, as tensors on ``device``
    in the models' layout: memory (K, I, J, *data_dims), J contiguous along
    the threads, viewed as (I, J, K, *data_dims)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    fields, scalars = make_inputs()
    out = {}
    for k, v in fields.items():
        spatial = min(v.ndim, 3)
        full = tuple(shape[:spatial]) + tuple(v.shape[3:])
        lo, hi = (v.min(), v.max()) if v.size else (0, 1)
        if v.dtype.kind in "iu":
            a = rng.integers(int(lo), int(hi) + 1, full).astype(v.dtype)
        else:
            a = (lo + (hi - lo) * rng.random(full)).astype(v.dtype)
        t = torch.from_numpy(a)
        if spatial == 3:
            t = t.movedim(2, 0).contiguous().movedim(0, 2)
        out[k] = t.to(device)
    return out, scalars


def _time_b2b_ms(fn, n):
    """Milliseconds per call of ``n`` calls enqueued back to back between
    two CUDA events, and the host's milliseconds per call to enqueue them
    (the host clock, no synchronisation inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, host


def _min_bytes(analysis, shape) -> int:
    """Bytes a stencil's function must move on a domain of ``shape``
    (I, J, K): each field it reads, read once, and each field it writes,
    written once (its temporaries stay out of device memory)."""
    import numpy as np

    n = 0
    for info in analysis.field_info.values():
        points = int(np.prod([s for s, on in zip(shape, info.dimensions) if on], dtype=np.int64))
        size = points * np.dtype(info.dtype).itemsize * int(np.prod(info.data_dims, dtype=int))
        n += size * (bool(info.access.value & 1) + bool(info.access.value & 2))
    return n


def _bound_ms(nbytes) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _bound(analysis, shape, library_ms=None) -> dict:
    """The ``bound_ms``/``bound_by``/``library_ms`` keys of a stencil."""
    return {"bound_ms": _bound_ms(_min_bytes(analysis, shape)), "bound_by": "bytes",
            "library_ms": library_ms}


# --------------------------------------------------------------------------- #
# phase 8
# --------------------------------------------------------------------------- #


def _perm(P, seed):
    """A random permutation ``sigma`` of P and its sort keys (the inverse),
    as ``benes.permute`` takes them."""
    import numpy as np

    sigma = np.random.default_rng(seed).permutation(P).astype(np.int64)
    keys = np.empty(P, dtype=np.int64)
    keys[sigma] = np.arange(P)
    return sigma, keys.astype(np.int32)


def _k9_bytes(plan) -> dict:
    """K9's bytes: ``function``, what the permutation must move (x in,
    y out, the network's control bits read once, one bit per pair and
    stage); ``model``, what this design moves (pass A reads the P words and
    writes n2 to the scratch buffer, the inner pass reads and writes n2,
    pass C reads n2 and writes the P words of the result; one pass moves P
    in and P out; the packed bits once, one bit per word and stage)."""
    pair_bits = (2 * plan.k - 1) * plan.n2 // 16
    moved = 8 * plan.P + (16 * plan.n2 if plan.launches == 3 else 0)
    return {"function": 8 * plan.P + pair_bits, "model": moved + plan.bits.nbytes}


def _profiled(fn, n, warmup=PROFILE_WARMUP, pad=PROFILE_PAD_S):
    """``torch.profiler`` over ``n`` calls of ``fn`` (run ``n`` times more
    first, as the profiler's warm-up cycle, with ``warmup``), the profile
    idle for ``pad`` seconds before the calls and after their device work
    has finished."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1) if warmup
                 else None) as prof:
        for _ in range(2 if warmup else 1):
            time.sleep(pad)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            if warmup:
                prof.step()
    return prof


def _device_rows(prof):
    """The device events of a profile by name: key -> (us, count)."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.key_averages():
        # device events only: a CPU op's device time repeats its kernels',
        # and the schedule's step annotation spans them
        if e.device_type == DeviceType.CPU or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows[e.key] = (us, e.count)
    return rows


#: profiles that showed fewer device events of a kernel than its library
#: counted launches (``_check_profile``); the script fails at its end if any
PROFILE_LOSSES = []


def _check_profile(prof, raw, made) -> None:
    """Hold a profile to the launches the libraries counted: ``made`` maps
    a part of kernel names to the launches made while it ran.  A shortfall
    is recorded in ``PROFILE_LOSSES`` with what the profile shows of it:
    the runtime's launch events, and where the kernels it kept start
    against their launches (matched by correlation id) and within the
    profile's span, in us."""
    from torch.autograd import DeviceType

    for part, m in made.items():
        seen = sum(c for k, (_, c) in raw.items() if part in k)
        if not raw or seen == m:
            continue
        events = list(prof.events())
        launch = {e.id: e for e in events
                  if e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunchKernel")}
        kern = sorted((e for e in events if e.device_type == DeviceType.CUDA and part in e.name),
                      key=lambda e: e.time_range.start)
        offs = [k.time_range.start - launch[k.id].time_range.start for k in kern
                if k.id in launch]
        t0 = min(e.time_range.start for e in events)
        t1 = max(e.time_range.end for e in events)
        loss = {"part": part, "seen": seen, "made": m, "launch_events": len(launch),
                "matched": len(offs),
                "kernel_minus_launch_us": [round(min(offs), 1), round(max(offs), 1)]
                if offs else None,
                "kernels_from_us": [round(kern[0].time_range.start - t0, 1),
                                    round(kern[-1].time_range.start - t0, 1)] if kern else None,
                "span_us": round(t1 - t0, 1), "process_age_s": round(time.time() - T_START, 1)}
        print(f"profile: {seen} device events of '{part}' kernels for {m} launches counted "
              f"by the library: {loss}")
        PROFILE_LOSSES.append(loss)


def _device_ms(fn, n=20, counted=()):
    """Device milliseconds per call of ``fn`` from ``torch.profiler`` (the
    device events over ``n`` calls), and by kernel: name -> (ms, launches)
    per call; (None, {}) when the profiler shows no device time.
    ``counted``: (part of a kernel name, the library's launch counter)
    pairs; the profile must hold, of the kernels whose names hold the part,
    as many device events as the counter counts launches
    (``_check_profile``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    before = [c() for _, c in counted]
    prof = _profiled(fn, n)
    raw = _device_rows(prof)
    cycles = 2 if PROFILE_WARMUP else 1
    _check_profile(prof, raw, {part: (c() - b) // cycles for (part, c), b in zip(counted, before)})
    rows = {k[:90]: (us / n / 1e3, m / n) for k, (us, m) in raw.items()}
    total = sum(ms for ms, _ in rows.values())
    return (total if total > 0 else None), rows


def _k9_raw(dev) -> list:
    """K9 on raw permutations: against ``x[sigma]`` and its plain version
    on the card, bit for bit, its launch count read around each run."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.next import benes

    out = []
    for P, dt in K9_RAW:
        sigma, keys = _perm(P, P)
        rng = np.random.default_rng(P + 1)
        if dt == "float32":
            x = torch.from_numpy(rng.random(P).astype(np.float32)).to(dev)
        else:
            words = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
            words[:len(NAN_PATTERNS)] = NAN_PATTERNS
            x = torch.from_numpy(words.view(np.int32)).to(dev)
        benes.KERNEL.build()
        before = benes.KERNEL.launches, benes.KERNEL.device_launches
        got = benes.permute(x, keys)
        torch.cuda.synchronize()
        launched = benes.KERNEL.launches - before[0]
        device = benes.KERNEL.device_launches - before[1]
        if launched != 1:
            raise AssertionError(f"K9 P={P} {dt}: {launched} permutes ran the kernel")
        sig = torch.from_numpy(sigma).to(dev)
        ref = x[sig]
        plan = benes._plan(keys)
        if device != plan.launches or device != 3:
            raise AssertionError(f"K9 P={P} {dt}: {device} kernel launches counted, "
                                 f"{plan.launches} planned (3 wanted)")
        plain = torch.zeros(plan.n2, dtype=torch.int32, device=dev)
        plain[:P] = x.view(torch.int32)
        benes.plain_inplace(plain, plan)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K9 P={P} {dt}: kernel != x[sigma]")
        if not torch.equal(got.view(torch.int32), plain[:P]):
            raise AssertionError(f"K9 P={P} {dt}: kernel != its plain version")
        # int32 words were compared bit for bit above
        err = float((got - ref).abs().max()) if dt == "float32" else 0.0
        print(f"K9 P={P} {dt}: launches {launched}, {device} kernel launches counted for the "
              f"permute, bitwise equal to x[sigma] and to the plain butterfly (n2 = 2^{plan.k}, "
              f"block 2^{plan.b}, row segment 2^{plan.c}: {plan.record()}), max abs err "
              f"{err:.3e}")
        out.append({"P": P, "dtype": dt, "launches": launched, "device_launches": device,
                    "max_abs_err": err, "plan": plan.record()})
    return out


def _fvm(dev) -> dict:
    """bench.py's unstructured FVM step at n = FVM_N float32 on both meshes:
    plans, K9's launches over 10 steps, the routed path against the index
    path bit for bit, and the times."""
    import numpy as np
    import torch

    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.next import affine_remap, benes, sort_route
    from gt4py_tpu_torch.next.testing import unstructured_fvm_case

    summary, cases = {}, {}
    for irregular in (False, True):
        label = "irregular" if irregular else "regular"
        t0 = time.perf_counter()
        case = unstructured_fvm_case(FVM_N, irregular, np.float32, dev)
        step, psi0, mesh = case["step"], case["psi0"], case["mesh"]
        psi = step(psi0)  # plans every gather (host), builds the router
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        conns = list(mesh.e2v.__dict__["_column_conns"].values()) + [mesh.v2e]
        affine = [affine_remap.plan_for(c) is not None for c in conns]
        routed = [affine_remap.plan_for(c) is None and sort_route.plan_for(c) is not None
                  for c in conns]
        if irregular and not all(routed):
            raise AssertionError(f"FVM {label}: a gather is not sort-routed ({routed})")
        if not irregular and not all(affine):
            raise AssertionError(f"FVM {label}: a gather has no affine plan ({affine})")
        declines = benes.DECLINES.cursor()
        benes.KERNEL.launches = 0
        device_before = benes.KERNEL.device_launches
        psi = psi0
        for _ in range(STEPS):
            psi = step(psi)
        torch.cuda.synchronize()
        k9 = benes.KERNEL.launches
        k9_device = benes.KERNEL.device_launches - device_before
        if k9_device != 3 * k9:
            raise AssertionError(f"FVM {label}: {k9_device} K9 kernel launches counted for "
                                 f"{k9} permutes (3 each wanted)")
        if irregular and k9 == 0:
            raise AssertionError("FVM irregular: K9 was never launched")
        if benes.DECLINES.since(declines):
            raise AssertionError(f"FVM {label}: K9 declined {benes.DECLINES.since(declines)}")
        saved = config.AFFINE_GATHER, config.SORT_GATHER
        config.AFFINE_GATHER = config.SORT_GATHER = False
        try:
            ref = psi0
            for _ in range(STEPS):
                ref = case["step"](ref)
            torch.cuda.synchronize()
            index_ms = _time_ms(lambda: step(psi0), TIMING_REPS)
            index_b2b, index_host = _time_b2b_ms(lambda: step(psi0), BACK_TO_BACK)
        finally:
            config.AFFINE_GATHER, config.SORT_GATHER = saved
        if tuple(psi.shape) != (mesh.n_vertices,) or not bool(torch.isfinite(psi).all()):
            raise AssertionError(f"FVM {label}: state not finite or of the wrong shape")
        if not torch.equal(psi, ref):
            raise AssertionError(f"FVM {label}: {STEPS} routed steps != {STEPS} index steps")
        ms = _time_ms(lambda: step(psi0), TIMING_REPS)
        b2b, host = _time_b2b_ms(lambda: step(psi0), BACK_TO_BACK)
        medges = mesh.n_edges / ms / 1e3
        print(f"FVM {label} n={FVM_N} f32 ({mesh.n_vertices} vertices, {mesh.n_edges} edges): "
              f"plans affine {affine}, sort-routed {routed}; K9 launches over {STEPS} steps "
              f"{k9} ({k9_device} kernel launches counted); {STEPS} steps bitwise equal to the "
              f"index path; set-up {setup_s:.2f} s")
        print(f"FVM {label}: {ms:.4f} ms per step one call at a time ({medges:.1f} Medges/s), "
              f"{b2b:.4f} ms back to back ({BACK_TO_BACK} calls, "
              f"{mesh.n_edges / b2b / 1e3:.1f} Medges/s), host enqueue {host:.4f} ms/step; "
              f"index path {index_ms:.4f} ms one at a time, {index_b2b:.4f} ms back to back, "
              f"host {index_host:.4f} ms/step")
        summary[label] = {"ms": ms, "b2b_ms": b2b, "host_ms": host, "medges_s": medges,
                          "index_ms": index_ms, "index_b2b_ms": index_b2b,
                          "index_host_ms": index_host, "k9_launches": k9,
                          "k9_device_launches": k9_device,
                          "n_edges": mesh.n_edges, "setup_s": setup_s}
        cases[label] = case
    summary["irregular"]["profile"] = _profile(cases["irregular"],
                                               summary["irregular"]["b2b_ms"])
    return {"summary": summary, "cases": cases}


def _profile(case, b2b_ms) -> dict:
    """``torch.profiler``: the irregular step's device time by kernel (and
    copy) over five steps, and the device's busy share of a step enqueued
    back to back (``b2b_ms``, CUDA events, unprofiled)."""
    import torch

    from gt4py_tpu_torch.next import benes

    step, state = case["step"], [case["psi0"]]
    step(state[0])
    torch.cuda.synchronize()

    def one():
        state[0] = step(state[0])

    made = benes.KERNEL.device_launches
    prof = _profiled(one, 5)
    raw = _device_rows(prof)
    _check_profile(prof, raw, {"benes_pass": (benes.KERNEL.device_launches - made)
                               // (2 if PROFILE_WARMUP else 1)})
    rows = [(k, us / 5, m / 5) for k, (us, m) in raw.items()]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total == 0:
        print("profile: the profiler shows no device time (not measured); the CUDA-event "
              "times above stand")
        return {"device_us_per_step": None}
    busy = total / (b2b_ms * 1e3)
    print(f"profile of the irregular step (5 steps, per step): device {total:.1f} us in "
          f"{sum(r[2] for r in rows):.0f} kernels and copies; busy {100 * busy:.1f}% of the "
          f"{b2b_ms:.4f} ms back-to-back step")
    for key, us, n in rows[:12]:
        print(f"  {us:9.1f} us  {100 * us / total:5.1f}%  x{n:<5.1f} {key[:90]}")
    return {"device_us_per_step": total, "busy_share": busy,
            "top": [{"name": k[:120], "us": us, "calls": n} for k, us, n in rows[:12]]}


def _k9_entry(dev, raw, fvm) -> dict:
    """K9's entry of the kernels line: its launches on the irregular FVM
    run, and its time per permute at the FVM's two shapes (E2V columns,
    P = 523264 padded to 2^19; V2E, P = 2^20) against its plain version,
    ``torch.index_select`` of the same permutation, and its bound: one
    call at a time (CUDA events, host launch included) and device time
    (``torch.profiler``, whose ``benes_pass`` launches per permute must be
    3).  Its device launches per permute are those counted on the
    irregular FVM run."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.next import benes

    case = fvm["cases"]["irregular"]
    mesh = case["mesh"]
    shapes = {"e2v": mesh.n_edges, "v2e": mesh.v2e.table.size}
    per_shape = {}
    for name, P in shapes.items():
        sigma, keys = _perm(P, 11)
        x = torch.from_numpy(np.random.default_rng(12).random(P).astype(np.float32)).to(dev)
        sig = torch.from_numpy(sigma).to(dev)
        plan = benes._plan(keys)
        ms = _time_ms(lambda: benes.permute(x, keys), TIMING_REPS)
        b2b, host = _time_b2b_ms(lambda: benes.permute(x, keys), BACK_TO_BACK)
        # the profile holds every launch the library counts (3 a permute)
        dev_ms, rows = _device_ms(lambda: benes.permute(x, keys),
                                  counted=[("benes_pass", lambda: benes.KERNEL.device_launches)])
        profiled = sum(n for key, (_, n) in rows.items() if "benes_pass" in key) \
            if rows else None
        buf = torch.zeros(plan.n2, dtype=torch.int32, device=dev)
        plain_ms = _time_ms(lambda: benes.plain_inplace(buf, plan), PLAIN_TIMING_REPS)
        lib_ms = _time_ms(lambda: torch.index_select(x, 0, sig), TIMING_REPS)
        lib_b2b, lib_host = _time_b2b_ms(lambda: torch.index_select(x, 0, sig), BACK_TO_BACK)
        lib_dev_ms, _ = _device_ms(lambda: torch.index_select(x, 0, sig))
        nbytes = _k9_bytes(plan)
        per_shape[name] = {"P": P, "n2": plan.n2, "layout": [plan.b, plan.c],
                           "profiled_launches_per_permute": profiled, "ms": ms,
                           "b2b_ms": b2b, "host_ms": host, "device_ms": dev_ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms, "library_b2b_ms": lib_b2b,
                           "library_host_ms": lib_host, "library_device_ms": lib_dev_ms,
                           "bound_ms": _bound_ms(nbytes["function"]),
                           "model_ms": _bound_ms(nbytes["model"])}
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
        print(f"K9 {name} P={P} (n2 2^{plan.k}, b {plan.b}, c {plan.c}, {profiled} benes_pass "
              f"launches per permute in the profile, {plan.record()}): kernel {ms:.4f} ms per "
              f"permute one call at a "
              f"time, {b2b:.4f} back to back (host enqueue {host:.4f}), device {fmt(dev_ms)}; "
              f"plain {plain_ms:.4f} ms; torch.index_select {lib_ms:.4f} ms, {lib_b2b:.4f} back "
              f"to back (host {lib_host:.4f}), device {fmt(lib_dev_ms)}; bound "
              f"{per_shape[name]['bound_ms']:.4f} ms "
              f"({nbytes['function']} B), this design's traffic {per_shape[name]['model_ms']:.4f} "
              f"ms ({nbytes['model']} B) at 3.35 TB/s")
    v = per_shape["v2e"]
    irregular = fvm["summary"]["irregular"]
    return {
        "name": "benes_permute (K9)",
        "route": "cuda",
        "source": "gt4py_tpu_torch/csrc/benes.cu",
        "replaces": "gt4py_tpu/next/benes.py:253 permute (_inner_kernel :213, pallas_call "
                    ":308; outer stages _xla_stage :204)",
        "launches": irregular["k9_launches"],
        "device_launches_per_permute": irregular["k9_device_launches"] / irregular["k9_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in raw),
        "ms": v["ms"],
        "device_ms": v["device_ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"],
        "bound_by": "bytes",
        "library_ms": v["library_ms"],
        "shapes": per_shape,
        "raw": raw,
    }


def _bf16_steps(models) -> dict:
    """One MiniDycore and one FvAdvection step in bfloat16 at 512x512x80:
    10 steps of the kernels against 10 plain steps (the state compared),
    the kernels' launches read around them, and both timed."""
    import torch

    (md, fv), (pmd, pfv) = models["cuda"], models["torch"]
    out = {}
    s0 = md.init_state(seed=0)
    f0 = fv.init_state(seed=0)
    step, pstep = md.step_fn(), pmd.step_fn()
    fstep, pfstep = fv.step_fn(), pfv.step_fn()
    stencils = {"hdiff": md.hdiff, "vadv_update": md.vadv_upd, "fv_step": fv.fv_step}
    for st in stencils.values():
        st.backend.launches = 0
    s, r = s0, s0
    q, rq = f0["q"], f0["q"]
    for _ in range(STEPS):
        s, r = step(s), pstep(r)
        q, rq = fstep(q, f0["cx"], f0["cy"]), pfstep(rq, f0["cx"], f0["cy"])
    torch.cuda.synchronize()
    launches = {n: st.backend.launches for n, st in stencils.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"bfloat16 steps: a kernel was not launched ({launches})")
    errs = {}
    for what, got, ref in (("MiniDycore u", s["u"], r["u"]),
                           ("MiniDycore utens_stage", s["utens_stage"], r["utens_stage"]),
                           ("FvAdvection q", q, rq)):
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"bfloat16 {what}: dtype {got.dtype}")
        errs[what] = _check_close(f"bfloat16 {what} after {STEPS} steps", got.float(),
                                  ref.float(), RTOL_F32, ATOL_F32)[0]
    points = NI * NJ * NK
    t = {"dycore_bf16_ms": _time_ms(lambda: step(s0), TIMING_REPS),
         "dycore_bf16_plain_ms": _time_ms(lambda: pstep(s0), PLAIN_TIMING_REPS),
         "fv_bf16_ms": _time_ms(lambda: fstep(f0["q"], f0["cx"], f0["cy"]), TIMING_REPS),
         "fv_bf16_plain_ms": _time_ms(lambda: pfstep(f0["q"], f0["cx"], f0["cy"]),
                                      PLAIN_TIMING_REPS)}
    print(f"bfloat16 512x512x80: launches over {STEPS} steps {launches}; kernels vs plain max "
          f"abs {errs}; MiniDycore step {t['dycore_bf16_ms']:.4f} ms "
          f"({points / t['dycore_bf16_ms'] / 1e6:.3f} Gpoint/s, plain "
          f"{t['dycore_bf16_plain_ms']:.4f}), FvAdvection step {t['fv_bf16_ms']:.4f} ms "
          f"(plain {t['fv_bf16_plain_ms']:.4f}), one call at a time")
    out.update(t, launches=launches, max_abs_err=errs)
    return out


# --------------------------------------------------------------------------- #
# phase 9
# --------------------------------------------------------------------------- #

#: the FullDycore step's prognostic outputs; phase 9's loss is the sum of
#: their squares
PROGNOSTIC = ("u", "q", "qsl")
#: central differences in float64 at 64x256x16: a step of 1e-8 along v keeps
#: the chance of crossing a limiter's branch point (hdiff's flux limiter,
#: the FV scheme's) near 1 % over the ~10^6 tests of a step, and the loss's
#: rounding over the step near 1e-9 of the derivative; rtol as the JAX test
FD_EPS = 1e-8
FD_RTOL = 1e-4


def _full_loss(step, state, u, q):
    out = step({**state, "u": u, "q": q})
    return sum((out[k] ** 2).sum() for k in PROGNOSTIC)


def _full_grad(step, state):
    """The gradient of ``_full_loss`` with respect to the initial u and q."""
    import torch

    u, q = (state[k].clone().requires_grad_() for k in ("u", "q"))
    return torch.autograd.grad(_full_loss(step, state, u, q), (u, q))


def _k8_bytes(analysis, shape) -> int:
    """K8's bytes for one call of a stencil on a domain of ``shape``: its
    inputs (every field, read once), the cotangents of the fields it writes
    and the gradients of its inputs, each written or read once."""
    import numpy as np

    n = 0
    for info in analysis.field_info.values():
        points = int(np.prod([s for s, on in zip(shape, info.dimensions) if on], dtype=np.int64))
        size = points * np.dtype(info.dtype).itemsize * int(np.prod(info.data_dims, dtype=int))
        n += size * (2 + bool(info.access.value & 2))
    return n


def _fvm_energy(case):
    """The JAX package's FVM energy, ``sum(divergence(gradient(psi))**2)``,
    on ``case``'s operators."""
    from gt4py_tpu_torch.next import as_field
    from gt4py_tpu_torch.next.testing import Vertex

    def energy(psi):
        g = case["gradient"](as_field((Vertex,), psi), offset_provider=case["provider"])
        d = case["divergence"](g, case["sign"], offset_provider=case["provider"])
        return (d.data ** 2).sum()

    return energy


def _routed_gradient(case) -> dict:
    """The sort-routed FVM energy's gradient at n = FVM_N float32: K9 runs
    once per forward permute and once per backward one (the inverse plan);
    the gradient is held to the index path's."""
    import torch

    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.next import benes

    energy = _fvm_energy(case)
    with torch.no_grad():
        before = benes.KERNEL.launches
        energy(case["psi0"])
        torch.cuda.synchronize()
        forward = benes.KERNEL.launches - before
    declines = benes.DECLINES.cursor()
    psi = case["psi0"].clone().requires_grad_()
    benes.KERNEL.launches = 0
    g = torch.autograd.grad(energy(psi), psi)[0]
    torch.cuda.synchronize()
    k9 = benes.KERNEL.launches
    if forward == 0 or k9 != 2 * forward:
        raise AssertionError(f"routed energy gradient: K9 launched {k9} times for {forward} "
                             f"forward permutes")
    if benes.DECLINES.since(declines):
        raise AssertionError(f"routed energy gradient: K9 declined {benes.DECLINES.since(declines)}")
    saved = config.AFFINE_GATHER, config.SORT_GATHER
    config.AFFINE_GATHER = config.SORT_GATHER = False
    try:
        psi_i = case["psi0"].clone().requires_grad_()
        g_index = torch.autograd.grad(energy(psi_i), psi_i)[0]
    finally:
        config.AFFINE_GATHER, config.SORT_GATHER = saved
    # the index path's backward sums with atomics, in no fixed order, and
    # entries are sums of terms of both signs: atol scales with the largest
    atol = 1e-6 * float(g_index.abs().max())
    err = _check_close("routed energy gradient vs the index path", g, g_index, 1e-5, atol)
    if not float(g.abs().max()) > 0:
        raise AssertionError("routed energy gradient is zero")
    print(f"routed FVM energy gradient n={FVM_N} f32: K9 launches {k9} = 2 x {forward} forward "
          f"permutes; vs the index path max abs {err[0]:.3e}, max rel {err[1]:.3e} (rtol 1e-5, "
          f"atol {atol:.3e}), bitwise equal {torch.equal(g, g_index)}")
    return {"k9_launches": k9, "forward_permutes": forward, "max_abs_err": err[0],
            "bitwise": torch.equal(g, g_index)}


#: the inputs phase 9 differentiates, by stencil: the FullDycore step's
#: gradient with respect to u and q (hdiff reads u and writes a clone of it,
#: vadv_update reads the diffused u twice and writes a clone of u), and the
#: MiniDycore step's tangent along u
GRAD_WANTED = {"hdiff": ("in_field", "out_field"), "vadv_update": ("u_stage", "u_pos", "u_out"),
               "fv_step": ("q",)}


def _grad_path(fd) -> dict:
    return {"hdiff": fd.dyn.hdiff, "vadv_update": fd.dyn.vadv_upd, "fv_step": fd.fv.fv_step}


def _derivative_builds(models) -> list:
    """Phase 9's derivative stencils (K8), made before the build so that
    nvcc builds them with the rest: the adjoints of the FullDycore path at
    both configurations, periodic, and the tangents of the MiniDycore path
    at 512x512x80."""
    out = []
    for key, (fd, _) in models.items():
        for name, st in _grad_path(fd).items():
            out.append(st.backend.derivative("adjoint", GRAD_WANTED[name], fd.nk, ("I", "J"))[1])
            if key == "f32" and name != "fv_step":
                out.append(st.backend.derivative("tangent", GRAD_WANTED[name])[1])
    return out


def _derivative_counts(path) -> dict:
    """Per stencil: the forward's launches and K8 engagements, the calls
    that ran the adjoint and the tangent stencils, the plain re-runs, and
    the kernel launches the adjoint and tangent libraries counted."""
    out = {}
    for name, st in path.items():
        b = st.backend
        d = b.derivative_backends()
        out[name] = {"launches": b.launches, "k8": b.derivative_calls,
                     "adjoint_calls": b.adjoint_calls, "tangent_calls": b.tangent_calls,
                     "plain_reruns": b.plain_reruns,
                     "adjoint_launches": sum(x.device_launches()["all"] for x in d["adjoint"]),
                     "tangent_launches": sum(x.device_launches()["all"] for x in d["tangent"])}
    return out


def _counts_since(now: dict, before: dict) -> dict:
    return {n: {k: v - before[n][k] for k, v in c.items()} for n, c in now.items()}


def _gradients(smi, models, fvm_case) -> dict:
    """Phase 9: the FullDycore step's gradient at 512x512x80 float32 with
    the forward on the kernels, against the plain executor's on the card;
    its times and peak memory; ``torch.func.jvp`` of the MiniDycore step;
    central differences at 64x256x16 float64; the routed FVM energy's
    gradient (K9 in both directions)."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, REPLACES

    fd, fd_plain = models["f32"]
    step, pstep = fd.step_fn(), fd_plain.step_fn()
    state = fd.init_state(seed=0)
    path = {**_grad_path(fd), "sl_step": fd.sl}
    adjoints = {n: st.backend.derivative_backends()["adjoint"] for n, st in path.items()}
    before = _derivative_counts(path)
    grads = _full_grad(step, state)
    torch.cuda.synchronize()
    counts = _counts_since(_derivative_counts(path), before)
    print(f"FullDycore gradient path (forward launches, K8 engagements, adjoint and tangent "
          f"calls, plain re-runs, adjoint and tangent kernel launches): {counts}")
    if min(c["launches"] for c in counts.values()) == 0:
        raise AssertionError(f"FullDycore gradient: a forward kernel was not launched ({counts})")
    for n in GRAD_WANTED:
        c = counts[n]
        if c["k8"] == 0 or c["adjoint_calls"] == 0 or c["adjoint_launches"] == 0:
            raise AssertionError(f"FullDycore gradient: {n}'s adjoint kernels did not run "
                                 f"({c}; {path[n].backend.derivative_plan})")
    reruns = {n: c["plain_reruns"] for n, c in counts.items() if c["plain_reruns"]}
    if reruns:
        raise AssertionError(f"FullDycore gradient: the plain re-run ran on the path ({reruns})")
    built = {n: len(st.backend.derivative_backends()["adjoint"]) - len(adjoints[n])
             for n, st in path.items()}
    if any(built.values()):
        print(f"FullDycore gradient: adjoint stencils built during the backward {built} "
              f"(not prepared for the parallel build)")
    ref = _full_grad(pstep, state)
    errs, rels, scale, bitwise = {}, {}, {}, {}
    for name, g, r in zip(("u", "q"), grads, ref):
        scale[name] = float(r.abs().max())
        errs[name], rels[name] = _check_close(f"FullDycore gradient d/d{name} vs plain", g, r,
                                              GRAD_RTOL_F32, GRAD_ATOL_F32 * scale[name])
        bitwise[name] = torch.equal(g, r)
        if not float(g.abs().max()) > 0:
            raise AssertionError(f"FullDycore gradient d/d{name} is zero")
    print(f"FullDycore 512x512x80 f32 gradient, backward on the adjoint kernels, vs the plain "
          f"executor's: max abs {errs} (the largest entry {scale}; max abs over it "
          f"{ {n: errs[n] / scale[n] for n in errs} }), max rel {rels}; held to rtol "
          f"{GRAD_RTOL_F32}, atol {GRAD_ATOL_F32} x the largest entry; bitwise {bitwise}")

    def leaves():
        return [state[k].clone().requires_grad_() for k in ("u", "q")]

    def fwd(stp):
        return lambda: _full_loss(stp, state, *leaves())

    def fwd_bwd(stp):
        def run():
            u, q = leaves()
            torch.autograd.grad(_full_loss(stp, state, u, q), (u, q))
        return run

    t = {"cuda fwd": _time_ms(fwd(step), TIMING_REPS),
         "cuda fwd+bwd": _time_ms(fwd_bwd(step), TIMING_REPS),
         "torch fwd": _time_ms(fwd(pstep), PLAIN_TIMING_REPS),
         "torch fwd+bwd": _time_ms(fwd_bwd(pstep), PLAIN_TIMING_REPS)}
    peak = {}
    for kind, stp in (("cuda", step), ("torch", pstep)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(stp)()
        torch.cuda.synchronize()
        peak[kind] = {"peak_bytes": torch.cuda.max_memory_allocated(), "base_bytes": base}
    for kind in ("cuda", "torch"):
        share = 1 - t[f"{kind} fwd"] / t[f"{kind} fwd+bwd"]
        print(f"FullDycore step gradient, forward on {kind}: forward {t[f'{kind} fwd']:.4f} ms, "
              f"forward + backward {t[f'{kind} fwd+bwd']:.4f} ms, backward share "
              f"{100 * share:.1f}%, peak {peak[kind]['peak_bytes'] / 2**30:.3f} GiB "
              f"(before the call {peak[kind]['base_bytes'] / 2**30:.3f} GiB); {smi}")

    # each derivative kernel's device time against its bound: the API
    # fields of its stencil, each read or written once, at 3.35 TB/s
    fwd_dev, _ = _device_ms(fwd(step), n=5)
    both_dev, rows = _device_ms(fwd_bwd(step), n=5)
    adjoint_kernels = []
    for n in GRAD_WANTED:
        for b in path[n].backend.derivative_backends()["adjoint"]:
            mine = {k: v for k, v in rows.items() if f"{b.analysis.stencil.name}_k" in k}
            ms = sum(v[0] for v in mine.values())
            launches = sum(v[1] for v in mine.values())
            bound = _bound(b.analysis, (NI, NJ, NK))["bound_ms"]
            rec = {"stencil": b.analysis.stencil.name, "of": n,
                   "forms": LAST_PLAN.get(b.analysis.stencil.name, {}).get("forms"),
                   "device_ms": ms if mine else None, "launches_per_call": launches,
                   "bound_ms": bound, "kernels": {k: v[0] for k, v in mine.items()}}
            if mine:
                adjoint_kernels.append(rec)
                print(f"K8 adjoint {rec['stencil']} ({n}) forms {rec['forms']}: device "
                      f"{ms:.4f} ms a backward ({launches:g} launches) against its bound "
                      f"{bound:.4f} ms ({100 * bound / ms:.1f} % of it); by kernel "
                      f"{rec['kernels']}; {smi}")
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:14]
    print("FullDycore step gradient, forward + backward, device ms a step by kernel: " +
          "; ".join(f"{k[:70]} {v[0]:.4f} ({v[1]:g})" for k, v in top))
    if fwd_dev is not None and both_dev is not None:
        print(f"FullDycore step gradient, device time: forward {fwd_dev:.4f} ms, forward + "
              f"backward {both_dev:.4f} ms, adjoint kernels "
              f"{sum(r['device_ms'] for r in adjoint_kernels):.4f} ms; {smi}")
    if len(adjoint_kernels) != len(GRAD_WANTED):
        raise AssertionError(f"FullDycore gradient: the profile shows adjoint kernels of "
                             f"{[r['of'] for r in adjoint_kernels]} only")

    # torch.func.jvp of the MiniDycore step
    md, md_plain = fd.dyn, fd_plain.dyn
    s0 = md.init_state(seed=0)
    tangent = torch.from_numpy(np.random.default_rng(5).random(tuple(s0["u"].shape)).astype(
        np.float32)).to(s0["u"].device)
    mpath = {"hdiff": md.hdiff, "vadv_update": md.vadv_upd}
    before = _derivative_counts(mpath)
    _, tang = torch.func.jvp(lambda u: md.step_fn()({**s0, "u": u})["u"], (s0["u"],), (tangent,))
    torch.cuda.synchronize()
    jc = _counts_since(_derivative_counts(mpath), before)
    jvp_counts = [(c["launches"], c["k8"], c["tangent_calls"], c["plain_reruns"])
                  for c in jc.values()]
    if jvp_counts != [(1, 1, 1, 0), (1, 1, 1, 0)] or \
            min(c["tangent_launches"] for c in jc.values()) == 0:
        raise AssertionError(f"MiniDycore jvp: (launches, under K8, tangent calls, plain "
                             f"re-runs) {jvp_counts}, {jc}")
    _, rtang = torch.func.jvp(lambda u: md_plain.step_fn()({**s0, "u": u})["u"], (s0["u"],),
                              (tangent,))
    jvp_err = _check_close("MiniDycore jvp vs plain", tang, rtang, RTOL_F32, ATOL_F32)[0]
    print(f"MiniDycore 512x512x80 f32 torch.func.jvp (kernels under K8 {jvp_counts}) vs the "
          f"plain executor's: max abs {jvp_err:.3e}, bitwise {torch.equal(tang, rtang)}")

    # torch.func.grad and torch.func.vjp through K8 against torch.autograd.grad
    def mloss(u):
        return (md.step_fn()({**s0, "u": u})["u"] ** 2).sum()

    leaf = s0["u"].clone().requires_grad_()
    g_ref = torch.autograd.grad(mloss(leaf), leaf)[0]
    before = _derivative_counts(mpath)
    g_func = torch.func.grad(mloss)(s0["u"])
    value, pull = torch.func.vjp(mloss, s0["u"])
    g_vjp = pull(torch.ones_like(value))[0]
    torch.cuda.synchronize()
    fc = _counts_since(_derivative_counts(mpath), before)
    func_counts = [(c["launches"], c["k8"], c["adjoint_calls"], c["plain_reruns"])
                   for c in fc.values()]
    if func_counts != [(2, 2, 2, 0), (2, 2, 2, 0)]:
        raise AssertionError(f"torch.func through K8: (launches, under K8, adjoint calls, "
                             f"plain re-runs) {func_counts}")
    func_err = max(_check_close(f"MiniDycore torch.func.{what} vs torch.autograd.grad", g, g_ref,
                                RTOL_F32, ATOL_F32)[0] for what, g in (("grad", g_func),
                                                                       ("vjp", g_vjp)))
    func_bitwise = torch.equal(g_func, g_ref) and torch.equal(g_vjp, g_ref)
    print(f"MiniDycore 512x512x80 f32 torch.func.grad and torch.func.vjp (kernels under K8 "
          f"{func_counts}) vs torch.autograd.grad: max abs {func_err:.3e}, bitwise {func_bitwise}")

    # central differences at 64x256x16 float64
    small, small_plain = models["f64"]
    sstate = small.init_state(seed=1)
    sstep = small.step_fn()
    before = _derivative_counts(_grad_path(small))
    gu, gq = _full_grad(sstep, sstate)
    sc = _counts_since(_derivative_counts(_grad_path(small)), before)
    if any(c["adjoint_calls"] == 0 or c["plain_reruns"] for c in sc.values()):
        raise AssertionError(f"FullDycore f64 gradient: not on the adjoint kernels ({sc})")
    ru, rq = _full_grad(small_plain.step_fn(), sstate)
    small_err = max(_check_close("FullDycore f64 gradient vs plain", a, b, RTOL_F64,
                                 ATOL_F64)[0] for a, b in ((gu, ru), (gq, rq)))
    rng = np.random.default_rng(6)
    vu, vq = (torch.from_numpy(rng.random(tuple(sstate[k].shape))).to(sstate[k].device)
              for k in ("u", "q"))
    dot = float((gu * vu).sum() + (gq * vq).sum())
    with torch.no_grad():
        fd_val = float(_full_loss(sstep, sstate, sstate["u"] + FD_EPS * vu,
                                  sstate["q"] + FD_EPS * vq)
                       - _full_loss(sstep, sstate, sstate["u"] - FD_EPS * vu,
                                    sstate["q"] - FD_EPS * vq)) / (2 * FD_EPS)
    rel = abs(dot - fd_val) / abs(fd_val)
    print(f"FullDycore {SMALL} f64: gradient vs plain max abs {small_err:.3e}; directional "
          f"derivative {dot:.10e} vs central differences {fd_val:.10e} (step {FD_EPS}): "
          f"rel {rel:.3e} (rtol {FD_RTOL})")
    if not rel <= FD_RTOL:
        raise AssertionError(f"directional derivative off central differences by {rel:.3e}")

    routed = _routed_gradient(fvm_case) if fvm_case is not None else None
    kbytes = sum(counts[n]["k8"] * _k8_bytes(st.analysis, (NI, NJ, NK))
                 for n, st in path.items())
    entry = {
        "name": "K8 derivative stencils (autodiff, derivative.py): FullDycore step gradient",
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/derivative.py",
        "replaces": REPLACES["autodiff"],
        "launches": sum(c["adjoint_launches"] for c in counts.values()),
        "max_abs_err": max(errs.values()),
        "ms": t["cuda fwd+bwd"],
        "plain_ms": t["torch fwd+bwd"],
        "bound_ms": _bound_ms(kbytes),
        "bound_by": "bytes",
        "library_ms": None,
        "device_ms": both_dev,
        "forward_device_ms": fwd_dev,
        "adjoint_kernels": adjoint_kernels,
        "max_rel_err": rels,
    }
    summary = {"launches": counts, "max_abs_err": errs, "max_rel_err": rels,
               "device_rows": {k[:90]: v for k, v in top},
               "bitwise": bitwise, "times_ms": t, "adjoint_kernels": adjoint_kernels,
               "device_ms": {"forward": fwd_dev, "forward+backward": both_dev},
               "memory": peak, "jvp_max_abs_err": jvp_err, "small_max_abs_err": small_err,
               "func_grad_max_abs_err": func_err, "func_grad_bitwise": func_bitwise,
               "fd_rel": rel, "routed": routed, "card": smi}
    return {"entry": entry, "summary": summary}


# --------------------------------------------------------------------------- #
# phase 10
# --------------------------------------------------------------------------- #


def _plane_defs() -> dict:
    """Phase 10 (a)'s stencils, float64: fault 1's loop, a K-carried
    temporary read at offsets (the CTA's ring of planes), reads of values
    the sweep has not written yet (the copy taken before the kernel), and
    the mixed stencils of ``tests/cartesian/test_serialize_parallel.py``
    (K5) built ``sweep=True`` and ``serialize=True``; by case name."""
    import numpy as np

    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.gtscript import (
        BACKWARD,
        FORWARD,
        PARALLEL,
        computation,
        interval,
    )

    F = gtscript.Field[np.float64]

    def fault1(a: F, b: F):
        with computation(FORWARD), interval(...):
            t = a + 1.0
            b = t[1, 0, 0]

    def ring(a: F, c: F):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t
            with interval(1, None):
                c = t[1, 0, -1]
                t = a * 2.0

    def carried(a: F, c: F):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t[1, 0, 0] + t[0, -1, 0]
            with interval(1, None):
                t = t[0, 0, -1] * 0.5 + a
                c = t[1, 0, 0] + t[0, -1, 0]

    def not_yet_swept(a: F, c: F):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t
            with interval(1, -1):
                c = t[1, 0, 0] + t[0, -1, 1]
                t = a * 2.0
            with interval(-1, None):
                t = a
                c = t

    def ser_mixed(a: F, out: F):
        with computation(PARALLEL), interval(...):
            t = a[1, 0, 0] + a[-1, 0, 0]
        with computation(FORWARD):
            with interval(0, 1):
                acc = t
                out = acc
            with interval(1, None):
                acc = acc[0, 0, -1] + t
                out = acc

    def ser_parity(a: F, b: F, out: F):
        with computation(PARALLEL), interval(...):
            lap = a[1, 0, 0] + a[-1, 0, 0] + a[0, 1, 0] + a[0, -1, 0] - 4.0 * a
            flx = lap[1, 0, 0] - lap[0, 0, 0]
        with computation(FORWARD):
            with interval(0, 1):
                acc = flx + b
                out = acc
            with interval(1, None):
                acc = acc[0, 0, -1] * 0.5 + flx
                out = acc
        with computation(BACKWARD):
            with interval(0, -1):
                out = out + out[0, 0, 1] * 0.25

    def pair(d, **options):
        return {"cuda": gtscript.stencil(backend="cuda", definition=d, rebuild=True, **options),
                "torch": gtscript.stencil(backend="torch", definition=d, rebuild=True)}

    defs = {d.__name__: pair(d) for d in (fault1, ring, carried, not_yet_swept)}
    # the mixed stencils in the sweep form (one kernel) and in the
    # plane-sweep form with the fused column kernel
    for d in (ser_mixed, ser_parity):
        defs[f"{d.__name__}_sweep"] = pair(d, sweep=True)
        defs[f"{d.__name__}_planes"] = pair(d, serialize=True)
    return defs


def _plane_modes(defs, dev) -> dict:
    """Phase 10 (a): each stencil in the plane-sweep form (the mixed ones
    in the sweep form and in the plane-sweep form) against plain, float64
    at SMALL, bounded and periodic, bit for bit; its launches read around
    the run, its forms from its ``LAST_PLAN`` entry after the call."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    out = {}
    shape = (SMALL[0] + 4, SMALL[1] + 4, SMALL[2])
    for name, pair in defs.items():
        st = pair["cuda"]
        form = "sweep" if name.endswith("_sweep") else "planes"
        for periodic in ((), ("I", "J")):
            rng = np.random.default_rng(10)
            fields = {n: rng.random(shape) for n in st.field_info}
            got = {}
            for backend, stc in pair.items():
                # J contiguous along the threads, as the models' buffers
                ts = {n: torch.from_numpy(v).movedim(2, 0).contiguous().movedim(0, 2).to(dev)
                      for n, v in fields.items()}
                if backend == "cuda":
                    stc.backend.launches = 0
                stc(**ts, origin=(2, 2, 0), domain=SMALL, periodic=periodic)
                torch.cuda.synchronize()
                got[backend] = ts
            launches = st.backend.launches
            if launches != 1:
                raise AssertionError(f"phase 10 {name}: launched {launches} times")
            plan = LAST_PLAN[st.name]
            if form not in plan["forms"] or bool(plan["widened"]) != (name == "ring"):
                raise AssertionError(f"phase 10 {name}: not in the {form} form, or widened "
                                     f"where it should not be ({plan})")
            for n, v in got["torch"].items():
                if not torch.equal(got["cuda"][n], v):
                    _check_close(f"phase 10 {name}.{n}", got["cuda"][n], v, RTOL_F64, ATOL_F64)
                    raise AssertionError(f"phase 10 {name}.{n}: kernels and plain differ")
            out[f"{name}{'_periodic' if periodic else ''}"] = {
                "launches": launches, "forms": plan["forms"], "serialized": plan["serialized"],
                "shared": plan["shared"], "tile": plan["tile"], "widened": plan["widened"]}
        print(f"phase 10 {name} f64 {SMALL}: forms {plan['forms']}, serialized "
              f"{plan['serialized']}, tile {plan['tile']}, shared {plan['shared']}, widened "
              f"{plan['widened']}; "
              "bounded and periodic bitwise equal to plain, 1 launch each")
    return out


def _fv_planes(fd, fv_planes) -> dict:
    """fv_step at 512x512x80 float32 built with ``serialize=True``: its 13
    stages as one plane-sweep kernel, bitwise against the default build
    (the tile form), both timed in turns."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    fv = fd.fv
    state = fd.init_state(seed=0)
    fn = fv_planes.functional(origin=(fv.oi, fv.oj, 0), domain=(NI, NJ, NK),
                              physical_layout=True, periodic=("I", "J"))
    args = dict(q=state["q"], cx=state["cx"], cy=state["cy"], qout=torch.zeros_like(state["q"]))
    fv_planes.backend.launches = 0
    got = fn(**args)["qout"]
    torch.cuda.synchronize()
    plan = LAST_PLAN[fv_planes.name]
    if fv_planes.backend.launches != 1 or plan["forms"] != ["planes"]:
        raise AssertionError(f"fv_step serialized: launches {fv_planes.backend.launches}, "
                             f"plan {plan}")
    ref = fv.fns["step_p"](**args)["qout"]
    if not torch.equal(got, ref):
        _check_close("fv_step serialized vs tile", got, ref, RTOL_F32, ATOL_F32)
        raise AssertionError("fv_step: the plane-sweep form and the tile form differ")
    t = {}
    for label in ("planes", "tile", "planes_again", "tile_again"):
        f = fn if label.startswith("planes") else fv.fns["step_p"]
        t[label] = _time_ms(lambda: f(**args), TIMING_REPS)
    print(f"fv_step {NI}x{NJ}x{NK} f32 serialized: one plane-sweep kernel (tile {plan['tile']}, "
          f"{plan['smem_bytes']} bytes of shared planes, {len(plan['shared'])} shared, "
          f"{len(plan['scratch'])} in device memory) {t['planes']:.4f} / "
          f"{t['planes_again']:.4f} ms against the tile kernel {t['tile']:.4f} / "
          f"{t['tile_again']:.4f} ms (in turns); bitwise equal")
    return {"ms": t, "tile": plan["tile"], "smem_bytes": plan["smem_bytes"],
            "shared": len(plan["shared"]), "scratch": len(plan["scratch"])}


def _deep_k(deep, deep512, dev) -> dict:
    """Phase 10 (b): 10 deep-K MiniDycore steps with vadv_update K-blocked
    against 10 of the one-pass build and 10 plain ones, bit for bit; the
    times of both forms (one call at a time and back to back, in turns)
    and of K4's plain counterpart; then K4 at 512x512x80, the depth sweep
    and the wide domains.  K4's launches on the K-blocked run are counted
    by vadv_update's library: one per column loop and call."""
    import torch

    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    mk, mo, mp = deep["kblocked"], deep["one_pass"], deep["plain"]
    state0 = mk.init_state(seed=0)
    runs, launches = {}, {}
    for label, m in (("kblocked", mk), ("one_pass", mo), ("plain", mp)):
        step = m.step_fn()
        for st in (m.hdiff, m.vadv_upd):
            if label != "plain":
                st.backend.build()
                st.backend.launches = 0
        if label == "kblocked":
            counted = m.vadv_upd.backend.device_launches()
        s = state0
        for _ in range(STEPS):
            s = step(s)
        torch.cuda.synchronize()
        if label == "kblocked":
            now = m.vadv_upd.backend.device_launches()
            k4_device = sum(now["kblocked"]) - sum(counted["kblocked"])
        runs[label] = s
        if label != "plain":
            launches[label] = {"hdiff": m.hdiff.backend.launches,
                               "vadv_update": m.vadv_upd.backend.launches}
            plan = LAST_PLAN[m.vadv_upd.name]
            if label == "kblocked":
                kplan = plan
            if bool(plan["kblocked"]) != (label == "kblocked"):
                raise AssertionError(f"deep-K {label}: vadv_update plan {plan}")
    if min(launches["kblocked"].values()) == 0:
        raise AssertionError(f"deep-K: a kernel was not launched ({launches})")
    shape = mk.field_shape()
    errs = {}
    for field in ("u", "utens_stage"):
        got = runs["kblocked"][field]
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"deep-K {field}: shape {tuple(got.shape)} or not finite")
        for other in ("one_pass", "plain"):
            if not torch.equal(got, runs[other][field]):
                _check_close(f"deep-K {field} vs {other}", got, runs[other][field], RTOL_F32,
                             ATOL_F32)
                raise AssertionError(f"deep-K {field}: K4 and {other} differ")
        errs[field] = 0.0
    kbs = mk.vadv_upd.backend.program.kblock_plan(DEEP[0] * DEEP[1], DEEP[2])[0]
    kb = kplan["kblocked"]
    if kb["KB"] != kbs or not all(8 <= k < DEEP[2] for k in kbs):
        raise AssertionError(f"deep-K: KB {kb['KB']}, planned {kbs}")
    n_loops = len(kb["KB"])
    calls = launches["kblocked"]["vadv_update"]
    if kb["launches_per_loop"] != [1] * n_loops or min(kb["slots"]) < 2 \
            or k4_device != n_loops * calls:
        raise AssertionError(f"deep-K: K4 plan {kb}, {k4_device} K4 launches counted over "
                             f"{calls} calls")
    print(f"deep-K MiniDycore {DEEP} f32: {STEPS} steps, launches {launches}; vadv_update "
          f"K-blocked with KB {kb['KB']} over {kb['passes']} passes (promoted {kb['promoted']}), "
          f"{kb['launches_per_loop']} launches per column loop (counted), {k4_device} K4 "
          f"launches counted over the {calls} calls, {kb['slots']} slots, "
          f"{kb['smem_bytes']} shared bytes, {kb['ctas_per_sm']} CTAs per SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), ptxas {_ptxas(mk.vadv_upd)}; "
          f"u and utens_stage bitwise equal to the one-pass build and to plain")

    diffused = mp.hdiff_fn_p(in_field=state0["u"], out_field=state0["u"],
                             coeff=state0["coeff"])["out_field"]
    args = dict(utens_stage=state0["utens_stage"], u_stage=diffused, wcon=state0["wcon"],
                u_pos=diffused, utens=state0["utens"], u_out=state0["u"], dtr_stage=3.0)
    t = {"kblocked": _time_ms(lambda: mk.vadv_upd_fn_p(**args), TIMING_REPS),
         "one_pass": _time_ms(lambda: mo.vadv_upd_fn_p(**args), TIMING_REPS)}
    t["kblocked_again"] = _time_ms(lambda: mk.vadv_upd_fn_p(**args), TIMING_REPS)
    t["one_pass_again"] = _time_ms(lambda: mo.vadv_upd_fn_p(**args), TIMING_REPS)
    steps = {"kblocked": _time_ms(lambda: mk.step_fn()(state0), TIMING_REPS),
             "one_pass": _time_ms(lambda: mo.step_fn()(state0), TIMING_REPS)}
    # back to back, in turns: K4, one pass, K4, one pass, ...
    pairs = []
    for _ in range(3):
        pairs.append((_time_b2b_ms(lambda: mk.vadv_upd_fn_p(**args), BACK_TO_BACK // 2)[0],
                      _time_b2b_ms(lambda: mo.vadv_upd_fn_p(**args), BACK_TO_BACK // 2)[0]))

    # K4's plain counterpart on the same call: the passes' blocks through the
    # plain executor, on the logical (I, J, K) views of the physical buffers
    origin = (mk.oi, mk.oj, 0)

    def plain_blocks():
        fields = {k: (v.clone() if k in ("utens_stage", "u_out") else v).permute(1, 2, 0)
                  for k, v in args.items() if k != "dtr_stage"}
        testing.plain_kblocked(mk.vadv_upd, fields, {"dtr_stage": 3.0}, origin, DEEP,
                               periodic=("I", "J"))

    plain_ms = _time_ms(plain_blocks, 1, warmup=1)
    whole_plain_ms = _time_ms(lambda: mp.vadv_upd_fn_p(**args), 1, warmup=1)
    print(f"deep-K vadv_update {DEEP} f32: K-blocked {t['kblocked']:.4f} / "
          f"{t['kblocked_again']:.4f} ms, one pass {t['one_pass']:.4f} / "
          f"{t['one_pass_again']:.4f} ms (in turns, one call at a time); back to back "
          f"({BACK_TO_BACK // 2} calls) K-blocked / one pass: "
          + "; ".join(f"{a:.4f} / {b:.4f}" for a, b in pairs)
          + f" ms; step K-blocked {steps['kblocked']:.4f} ms, one pass {steps['one_pass']:.4f} "
          f"ms; plain counterpart (blocks) {plain_ms:.4f} ms, whole plain {whole_plain_ms:.4f} ms")
    headline = _kblocked_512(deep512)
    depths = _depth_sweep(dev)
    wide = _wide_sweep(dev)
    return {"launches": launches, "k4_device_launches": k4_device,
            "depths": depths, "wide": wide, "plan": kplan, "ms": t, "step_ms": steps,
            "b2b_pairs_ms": pairs, "plain_ms": plain_ms, "whole_plain_ms": whole_plain_ms,
            "max_abs_err": errs, "at_512x512x80": headline, "analysis": mk.vadv_upd.analysis}


def _depth_sweep(dev) -> dict:
    """vadv_update at 128 x 128 x dK for each of ``DEPTHS``, K4
    (``k_blocked=True``) against one pass (``k_blocked=False``): bit for
    bit, then timed in turns, one call at a time and back to back (two
    pairs each)."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.models import dycore

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, kb_default

    out = {}
    for dK in DEPTHS:
        m = {label: dycore.MiniDycore(DEEP[0], DEEP[1], dK, dtype=np.float32, backend="cuda",
                                      device=dev, options=options)
             for label, options in (("kblocked", {"k_blocked": True}),
                                    ("one_pass", {"k_blocked": False}), ("default", {}))}
        state = m["one_pass"].init_state(seed=0)
        diffused = m["one_pass"].hdiff_fn_p(in_field=state["u"], out_field=state["u"],
                                            coeff=state["coeff"])["out_field"]
        args = dict(utens_stage=state["utens_stage"], u_stage=diffused, wcon=state["wcon"],
                    u_pos=diffused, utens=state["utens"], u_out=state["u"], dtr_stage=3.0)
        calls = {label: (lambda md=md: md.vadv_upd_fn_p(**args)) for label, md in m.items()}
        default = calls.pop("default")()
        default_k4 = bool(LAST_PLAN[m["default"].vadv_upd.name]["kblocked"])
        if default_k4 != kb_default(DEEP[0] * DEEP[1], dK):
            raise AssertionError(f"K4 at depth {dK}: the default K-blocked {default_k4}")
        got, ref = calls["kblocked"](), calls["one_pass"]()
        torch.cuda.synchronize()
        for k, v in ref.items():
            if not (torch.equal(got[k], v) and torch.equal(default[k], v)):
                raise AssertionError(f"K4 at depth {dK}: {k} differs from the one-pass build")
        row = {"ms": {label: [] for label in calls}, "b2b_ms": {label: [] for label in calls}}
        for _ in range(2):
            for label, fn in calls.items():
                row["ms"][label].append(_time_ms(fn, TIMING_REPS))
                row["b2b_ms"][label].append(_time_b2b_ms(fn, BACK_TO_BACK // 2)[0])
        row["default_kblocked"] = default_k4
        out[dK] = row
        print(f"K4 vadv_update {DEEP[0]}x{DEEP[1]}x{dK} f32 (the default build K-blocked: "
              f"{default_k4}), bitwise equal; K-blocked / one "
              f"pass, back to back: " + "; ".join(
                  f"{a:.4f} / {b:.4f}" for a, b in zip(row["b2b_ms"]["kblocked"],
                                                       row["b2b_ms"]["one_pass"]))
              + " ms; one call at a time: " + "; ".join(
                  f"{a:.4f} / {b:.4f}" for a, b in zip(row["ms"]["kblocked"],
                                                       row["ms"]["one_pass"])) + " ms")
    return out


def _wide_sweep(dev) -> dict:
    """vadv_update on the ``WIDE`` domains, where one pass already has a
    thread for most of the card: K4 (``k_blocked=True``) against one pass
    (``k_blocked=False``), bit for bit and with the default build's choice
    checked against ``cuda_backend.kb_default``, then three back-to-back
    pairs in turns.  Each domain's models are freed before the next."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, kb_default
    from gt4py_tpu_torch.models import dycore

    out = {"held_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    print(f"K4 wide domains: {out['held_gib']:.2f} GiB of device memory held by the earlier "
          "phases")
    for dI, dJ, dK in WIDE:
        m = {label: dycore.MiniDycore(dI, dJ, dK, dtype=np.float32, backend="cuda",
                                      device=dev, options=options)
             for label, options in (("kblocked", {"k_blocked": True}),
                                    ("one_pass", {"k_blocked": False}), ("default", {}))}
        state = m["one_pass"].init_state(seed=0)
        diffused = m["one_pass"].hdiff_fn_p(in_field=state["u"], out_field=state["u"],
                                            coeff=state["coeff"])["out_field"]
        args = dict(utens_stage=state["utens_stage"], u_stage=diffused, wcon=state["wcon"],
                    u_pos=diffused, utens=state["utens"], u_out=state["u"], dtr_stage=3.0)
        calls = {label: (lambda md=md: md.vadv_upd_fn_p(**args)) for label, md in m.items()}
        ref = calls["one_pass"]()
        for label in ("default", "kblocked"):
            got = calls[label]()
            plan = LAST_PLAN[m[label].vadv_upd.name]
            if label == "default":
                default_k4 = bool(plan["kblocked"])
                if default_k4 != kb_default(dI * dJ, dK):
                    raise AssertionError(f"K4 at {dI}x{dJ}x{dK}: the default K-blocked "
                                         f"{default_k4}")
            else:
                kb = plan["kblocked"]
            for k, v in ref.items():
                if not torch.equal(got[k], v):
                    raise AssertionError(f"K4 at {dI}x{dJ}x{dK}: {label} {k} differs from "
                                         "one pass")
            del got
        del calls["default"]
        pairs = [(_time_b2b_ms(calls["kblocked"], BACK_TO_BACK // 2)[0],
                  _time_b2b_ms(calls["one_pass"], BACK_TO_BACK // 2)[0]) for _ in range(3)]
        out[f"{dI}x{dJ}x{dK}"] = {"b2b_pairs_ms": pairs, "default_kblocked": default_k4,
                                  "KB": kb["KB"], "ctas_per_sm": kb["ctas_per_sm"]}
        print(f"K4 vadv_update {dI}x{dJ}x{dK} f32 ({dI * dJ} columns, KB {kb['KB']}, "
              f"{kb['ctas_per_sm']} CTAs per SM; the default build K-blocked: {default_k4}), "
              f"bitwise equal; K-blocked / one pass, back to back ({BACK_TO_BACK // 2} calls): "
              + "; ".join(f"{a:.4f} / {b:.4f}" for a, b in pairs) + " ms")
        del m, state, diffused, args, calls, ref
        torch.cuda.empty_cache()
    return out


def _kblocked_512(deep512) -> dict:
    """K4's vadv_update at 512x512x80 float32 against the one-pass build
    (the default there), for the record: bit for bit, and both timed in
    turns, one call at a time."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    mk, mo = deep512["kblocked"], deep512["one_pass"]
    state = mo.init_state(seed=0)
    diffused = mo.hdiff_fn_p(in_field=state["u"], out_field=state["u"],
                             coeff=state["coeff"])["out_field"]
    args = dict(utens_stage=state["utens_stage"], u_stage=diffused, wcon=state["wcon"],
                u_pos=diffused, utens=state["utens"], u_out=state["u"], dtr_stage=3.0)
    got = mk.vadv_upd_fn_p(**args)
    kb = LAST_PLAN[mk.vadv_upd.name]["kblocked"]
    ref = mo.vadv_upd_fn_p(**args)
    torch.cuda.synchronize()
    for k, v in ref.items():
        if not torch.equal(got[k], v):
            raise AssertionError(f"K4 at 512x512x80: {k} differs from the one-pass build")
    t = {}
    for label in ("kblocked", "one_pass", "kblocked_again", "one_pass_again"):
        m = mk if label.startswith("kblocked") else mo
        t[label] = _time_ms(lambda: m.vadv_upd_fn_p(**args), TIMING_REPS)
    print(f"K4 vadv_update 512x512x80 f32 (KB {kb['KB']}, {kb['ctas_per_sm']} CTAs per SM): "
          f"{t['kblocked']:.4f} / {t['kblocked_again']:.4f} ms against one pass "
          f"{t['one_pass']:.4f} / {t['one_pass_again']:.4f} ms (in turns), bitwise equal")
    return {"ms": t, "KB": kb["KB"], "ctas_per_sm": kb["ctas_per_sm"]}


# --------------------------------------------------------------------------- #
# phase 11
# --------------------------------------------------------------------------- #


def _repair_defs(dtype) -> dict:
    """Phase 11 (a)'s stencils, the definitions of
    ``tests/cartesian/test_geometry_repair.py`` in ``dtype``: name ->
    {backend: stencil}; the ``"cuda"`` builds in K6's vector row form
    (``tiles=False``, whatever a section's stages)."""
    import numpy as np

    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.gtscript import (
        FORWARD,
        PARALLEL,
        I,
        J,
        computation,
        horizontal,
        interval,
        region,
    )

    F = gtscript.Field[dtype]

    def outop(inp: F, fx: F, fy: F, coeff: F, res: F):
        with computation(PARALLEL), interval(...):
            res = inp - coeff * (fx - fx[-1, 0, 0] + fy - fy[0, -1, 0])

    def lapd(a: F, b: F):
        with computation(PARALLEL), interval(...):
            b = a[1, 0, 0] + a[-1, 0, 0] + a[0, 1, 0] + a[0, -1, 0] - 4.0 * a

    def serk(a: F, b: F):
        with computation(FORWARD):
            with interval(0, 1):
                b = a
            with interval(1, 3):
                b = b[0, 0, -1] * 0.5 + a

    def while_loop(a: F, b: F):
        with computation(PARALLEL), interval(...):
            x = a
            while x < 1.0:
                x = x * 2.0 + 0.1
            b = x

    def region_end(a: F, b: F):
        with computation(PARALLEL), interval(...):
            b = a
            with horizontal(region[I[-1] - 1:, :]):
                b = a + 1.0
            with horizontal(region[: I[0] + 1, J[-1] - 2:]):
                b = a - 2.0

    name = np.dtype(dtype).name
    return {d.__name__: {backend: gtscript.stencil(backend=backend, definition=d, rebuild=True,
                                                   name=f"{d.__name__}_{name}", **options)
                         for backend, options in (("cuda", {"tiles": False}), ("torch", {}))}
            for d in (outop, lapd, serk, while_loop, region_end)}


def _in_layout(a, layout, dev):
    """A numpy (I, J, K) array on ``dev``: as it is (``"ijk"``, J strided
    by K: no vector access) or in the models' (K, I, J) memory order viewed
    as (I, J, K) (``"kij"``)."""
    import torch

    t = torch.from_numpy(a)
    if layout == "kij":
        t = t.movedim(2, 0).contiguous().movedim(0, 2)
    return t.to(dev)


def _repair_shapes(defs, dev) -> dict:
    """Phase 11 (a): each repair shape in float32 and float64, in both
    layouts, by default (no copy), kernels against plain bit for bit over
    the whole buffers (so every byte outside the write window kept its
    value), one launch each; the plan's vector width and staging."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    out = {}
    for (name, dtype), pair in defs.items():
        shapes, origins, domain = REPAIR_SHAPES[name]
        for layout in ("ijk", "kij"):
            rng = np.random.default_rng(11)
            scale = 0.5 if name == "while_loop" else 1.0
            arrays = {k: (scale * rng.random(s)).astype(dtype) for k, s in shapes.items()}
            got = {}
            for backend, st in pair.items():
                ts = {k: _in_layout(v, layout, dev) for k, v in arrays.items()}
                st.backend.launches = 0
                st(**ts, origin=origins, domain=domain)
                torch.cuda.synchronize()
                got[backend] = ts
            st = pair["cuda"]
            plan = LAST_PLAN[st.name]
            # by default nothing is repaired: the vector row kernels run
            # where the fields share a 16-byte phase, the scalar ones elsewhere
            vector = "rows" in plan["forms"] and layout == "kij" and \
                np.dtype(dtype).itemsize not in REPAIR_NO_PHASE_KIJ.get(name, ())
            if st.backend.launches != 1 or bool(plan.get("vector")) != vector or "repair" in plan:
                raise AssertionError(f"phase 11 {st.name} {layout}: launches "
                                     f"{st.backend.launches}, plan {plan}")
            for k, v in got["torch"].items():
                if not torch.equal(got["cuda"][k], v):
                    _check_close(f"phase 11 {st.name}.{k} {layout}", got["cuda"][k], v,
                                 RTOL_F64, ATOL_F64)
                    raise AssertionError(f"phase 11 {st.name}.{k} {layout}: kernels and "
                                         "plain differ")
            out[f"{st.name} {layout}"] = {"forms": plan["forms"], "vector": plan.get("vector"),
                                          "staging": plan.get("staging")}
            print(f"phase 11 {st.name} {layout} domain {domain}: forms {plan['forms']}, vector "
                  f"{plan.get('vector')}, staging {plan.get('staging')}, no repair; bitwise "
                  "equal to plain over the whole buffers")
    return out


def _run_steps(step, state, n):
    import torch

    for _ in range(n):
        state = step(state)
    torch.cuda.synchronize()
    return state


def _same(what, got, ref, names) -> float:
    """Fields ``names`` of two states: finite, of one shape, bit for bit;
    returns their largest absolute difference."""
    import torch

    err = 0.0
    for k in names:
        g, r = got[k], ref[k]
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {k}: shape {tuple(g.shape)} or not finite")
        if not torch.equal(g, r):
            _check_close(f"{what} {k}", g, r, RTOL_F32, ATOL_F32)
            raise AssertionError(f"{what} {k}: kernels and plain differ")
        err = max(err, _errors(g, r)[0])
    return err


def _in_turns(calls, reps=TIMING_REPS) -> dict:
    """Median CUDA-event ms of each call of ``calls`` (label -> call),
    twice, in turns: ``{label: [first, second]}``."""
    t = {label: [] for label in calls}
    for _ in range(2):
        for label, call in calls.items():
            t[label].append(_time_ms(call, reps))
    return t


def _phase11(p11, tight, dev, kernels) -> dict:
    """Phase 11 (b) and (c): ShallowWater and the tight-halo local steps at
    512x512x80 float32 by default (row-phase staging, no copy) and with the
    repair forced, against plain; the forms timed in turns; the tile
    kernels' device time on tight buffers (``_tight_tiles``); K6's entry."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend import cuda_backend, repair
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, REPLACES
    from gt4py_tpu_torch.models import spectral

    uvh = ("h", "u", "v")

    def sw_state(step):
        return lambda s: dict(zip(uvh, step(*(s[k] for k in uvh))))

    # -- (b) ShallowWater: step_fn (aligned, K1 + K1a) and local_step_fn
    # (tight, halo 2: the vector form on a shifted phase, no copy)
    sw, swp = p11["sw"], p11["sw_plain"]
    vlaunch = {}
    paths = {}
    sw_err = 0.0
    for aligned, entry in ((True, "step_fn"), (False, "local_step_fn")):
        m, mp = sw[(aligned, "vector")], swp[aligned]
        st = m.stencil
        st.backend.launches = st.backend.vector_launches = st.backend.repairs = 0
        s0 = m.init_state()
        got = _run_steps(sw_state(getattr(m, entry)()), s0, STEPS)
        launches = (st.backend.launches, st.backend.vector_launches, st.backend.repairs)
        plan = LAST_PLAN[st.name]
        if launches != (STEPS, STEPS, 0) or plan.get("vector") != 4 or "repair" in plan:
            raise AssertionError(f"ShallowWater {entry}: launches {launches}, plan {plan}")
        vlaunch[f"sw {entry}"] = st.backend.vector_launches
        sw_err = max(sw_err, _same(f"ShallowWater {entry} after {STEPS} steps", got,
                                   _run_steps(sw_state(getattr(mp, entry)()), s0, STEPS), uvh))
        s = sw_state(getattr(m, entry)())
        sc = sw_state(getattr(sw[(aligned, "scalar")], entry)())
        one = _in_turns({"vector": lambda: s(s0), "scalar": lambda: sc(s0)})
        b2b = {"vector": _time_chain_ms(s, s0, BACK_TO_BACK),
               "scalar": _time_chain_ms(sc, s0, BACK_TO_BACK)}
        b2b["vector_again"] = _time_chain_ms(s, s0, BACK_TO_BACK)
        b2b["scalar_again"] = _time_chain_ms(sc, s0, BACK_TO_BACK)
        plain_ms = _time_ms(lambda: sw_state(getattr(mp, entry)())(s0), PLAIN_TIMING_REPS)
        paths[f"sw {entry}"] = {"ms": one, "b2b_ms": b2b, "plain_ms": plain_ms,
                                "layout": list(m.field_shape()), "origin": [m.oi, m.oj, 0]}
        print(f"ShallowWater {NI}x{NJ}x{NK} f32 {entry} ({'aligned' if aligned else 'tight'}, "
              f"buffers {m.field_shape()}): {STEPS} steps bitwise equal to plain, vector "
              f"{STEPS} launches; vector {one['vector']} ms, scalar {one['scalar']} ms (one call "
              f"at a time, in turns); back to back {b2b}; plain {plain_ms:.4f} ms")

    # mass over 20 periodic steps, float64 at SMALL
    m = p11["sw_f64"]
    s = m.init_state()
    interior = (slice(None), slice(m.oi, m.oi + SMALL[0]), slice(m.oj, m.oj + SMALL[1]))
    mass0 = float(s["h"][interior].double().sum())
    s = _run_steps(sw_state(m.step_fn()), s, 20)
    mass = float(s["h"][interior].double().sum())
    if abs(mass - mass0) > 1e-12 * abs(mass0) or float(s["u"][interior].abs().max()) == 0:
        raise AssertionError(f"ShallowWater f64 mass {mass0!r} -> {mass!r}")
    print(f"ShallowWater {SMALL} f64: mass {mass0!r} -> {mass!r} over 20 periodic steps "
          f"(relative change {abs(mass - mass0) / abs(mass0):.3e}, bound 1e-12)")

    # spectral transforms against their numpy versions
    rng = np.random.default_rng(12)
    q = rng.random((NK, NI, NJ)).astype(np.float32)
    qd = torch.from_numpy(q).to(dev)
    spec = {}
    for name, args in (("spectral_filter", (1.0,)), ("poisson_solve", ())):
        got = getattr(spectral, name)(qd, *args)
        ref = torch.from_numpy(getattr(spectral, name + "_numpy")(q, *args))
        err = float((got.cpu().double() - ref.double()).abs().max())
        scale = float(ref.double().abs().max())
        if got.dtype != torch.float32 or not err <= 1e-5 * scale:
            raise AssertionError(f"{name}: max abs err {err} against max {scale}")
        spec[name] = {"max_abs_err": err, "max_abs_ref": scale,
                      "ms": _time_ms(lambda: getattr(spectral, name)(qd, *args), TIMING_REPS)}
        print(f"{name} {NK}x{NI}x{NJ} f32 (torch.fft): max abs err {err:.3e} against numpy "
              f"(max |ref| {scale:.3e}, bound 1e-5 of it); {spec[name]['ms']:.4f} ms")

    # -- (c) the tight-halo local steps (K1, K2, K5, K6): by default on the
    # caller's buffers, each row staged from its aligned-down word; and
    # with the repair forced (repair=True)
    md, mdp = p11["md_tight"], p11["md_tight_plain"]
    s0 = md["default"].init_state(seed=0)
    for fused in (False, True):
        label = "fused step" if fused else "step"
        for form, m in md.items():
            sts = [m.fused] if fused else [m.hdiff, m.vadv_upd]
            for st in sts:
                st.backend.launches = st.backend.vector_launches = st.backend.repairs = 0
            got = _run_steps(m.step_fn(fill_halos=False, fused=fused), s0, STEPS)
            counts = {st.name: (st.backend.launches, st.backend.vector_launches,
                                st.backend.repairs) for st in sts}
            want = STEPS if form == "repair" else 0
            if any(c[0] != STEPS or c[2] != want for c in counts.values()):
                raise AssertionError(f"tight MiniDycore {label} ({form}): (launches, vector, "
                                     f"repairs) {counts}")
            if form == "default":
                vlaunch[f"md tight {label}"] = sum(c[1] for c in counts.values())
            _same(f"tight MiniDycore {label} ({form}) after {STEPS} steps", got,
                  _run_steps(mdp.step_fn(fill_halos=False, fused=fused), s0, STEPS),
                  ("u", "utens_stage"))
            print(f"tight MiniDycore {NI}x{NJ}x{NK} f32 {label} (buffers {m.field_shape()}, "
                  f"{form}): {STEPS} steps bitwise equal to plain; (launches, vector launches, "
                  f"repairs) {counts}; plans " + "; ".join(
                      f"{st.name}: forms {LAST_PLAN[st.name]['forms']}, staging "
                      f"{LAST_PLAN[st.name].get('staging')}, repair "
                      f"{LAST_PLAN[st.name].get('repair')}" for st in sts))
    md_steps = _in_turns({label: (lambda m=m: m.step_fn(fill_halos=False)(s0))
                          for label, m in md.items()})
    fv, fvp = p11["fv_tight"], p11["fv_tight_plain"]
    f0 = fv["default"].init_state(seed=0)
    cx, cy = fv["default"].fill_winds(f0["cx"], f0["cy"])
    fv_counts = {}
    for form, m in fv.items():
        st = m.fv_step
        st.backend.launches = st.backend.vector_launches = st.backend.repairs = 0
        q = f0["q"]
        step = m.local_step_fn()
        for _ in range(STEPS):
            q = step(q, cx, cy)
        torch.cuda.synchronize()
        counts = fv_counts[form] = (st.backend.launches, st.backend.vector_launches,
                                    st.backend.repairs)
        if counts != (STEPS, STEPS, STEPS if form == "repair" else 0):
            raise AssertionError(f"tight FvAdvection ({form}): (launches, vector, repairs) "
                                 f"{counts}")
        qp = f0["q"]
        for _ in range(STEPS):
            qp = fvp.local_step_fn()(qp, cx, cy)
        _same(f"tight FvAdvection ({form}) after {STEPS} steps", {"q": q}, {"q": qp}, ("q",))
    vlaunch["fv tight local_step_fn"] = fv_counts["default"][1]
    fv_steps = _in_turns({label: (lambda m=m: m.local_step_fn()(f0["q"], cx, cy))
                          for label, m in fv.items()})
    print(f"tight FvAdvection {NI}x{NJ}x{NK} f32 local_step_fn: {STEPS} steps bitwise equal to "
          f"plain, (launches, vector, repairs) {fv_counts}, staging "
          f"{LAST_PLAN[fv['default'].fv_step.name].get('staging')}; step ms in turns "
          f"{fv_steps}; tight MiniDycore step ms in turns {md_steps}")

    # K6 on one call: tight hdiff by default (row-phase staging), with the
    # repair forced, the repair's copies alone, plain
    args = dict(in_field=s0["u"], out_field=s0["u"], coeff=s0["coeff"])
    hd = {label: m.hdiff_fn for label, m in md.items()}
    hd["plain"] = mdp.hdiff_fn
    ref = hd["plain"](**args)["out_field"]
    err = 0.0
    for label in ("repair", "default"):
        got = hd[label](**args)["out_field"]
        if label == "repair":
            rplan = dict(LAST_PLAN[md["repair"].hdiff.name])
        err = max(err, _errors(got, ref)[0])
        if not torch.equal(got, ref):
            raise AssertionError(f"tight hdiff ({label}) and plain differ")
    an = md["repair"].hdiff.analysis
    views = {k: v.permute(1, 2, 0) for k, v in args.items()}
    origins = {k: (md["repair"].oi, md["repair"].oj, 0) for k in views}
    pads = {k: tuple(tuple(x) for x in v) for k, v in rplan["repair"].items()}
    written = [n for n in pads if an.field_info[n].access.value & 2]
    views["out_field"] = views["out_field"].clone()

    def copies():
        padded, _ = repair.pad_fields(an, views, origins, (NI, NJ, NK), pads,
                                      set(rplan["repair_in"]))
        repair.write_back(an, views, origins, padded, (NI, NJ, NK), pads, written)

    hd_ms = _in_turns({"repair": lambda: hd["repair"](**args), "default":
                       lambda: hd["default"](**args), "copies": copies})
    hd_plain = _time_ms(lambda: hd["plain"](**args), PLAIN_TIMING_REPS)
    copy_rate = rplan["repair_bytes"] / (min(hd_ms["copies"]) * 1e-3)
    print(f"K6 tight hdiff {NI}x{NJ}x{NK} f32: row-phase staging on the caller's buffers "
          f"{hd_ms['default']} ms, repaired (forced) {hd_ms['repair']} ms, the repair's copies "
          f"alone {hd_ms['copies']} ms ({rplan['repair_bytes']} bytes: {copy_rate:.4e} B/s), "
          f"plain {hd_plain:.4f} ms; pads {rplan['repair']}")
    tiles = _tight_tiles(tight)

    # the vector and scalar row forms on aligned periodic calls (K1)
    forms = {}
    for name, pair, call in p11["aligned_calls"]:
        t = _in_turns({form: (lambda c=call, st=st: c(st)) for form, st in pair.items()})
        got = {form: call(st) for form, st in pair.items()}
        if not torch.equal(got["vector"], got["scalar"]):
            raise AssertionError(f"{name}: the vector and scalar forms differ")
        st = pair["vector"]
        forms[st.name] = {"vector_ms": t["vector"], "scalar_ms": t["scalar"]}
        print(f"{st.name} {NI}x{NJ}x{NK} f32 aligned, periodic: vector form {t['vector']} ms, "
              f"scalar form {t['scalar']} ms (in turns; bitwise equal)")
    for e in kernels:
        if e["name"] in forms:
            e["vector_ms"] = min(forms[e["name"]]["vector_ms"])
            e["scalar_ms"] = min(forms[e["name"]]["scalar_ms"])
    # the vector form is the default only where it was no slower than the
    # scalar form on all three of hdiff, fv_step and sw_step (best of two)
    no_slower = {n: min(forms[n]["vector_ms"]) <= min(forms[n]["scalar_ms"])
                 for n in ("hdiff_float32", "fv_step_float32", "sw_step_float32")}
    print(f"vector form no slower than the scalar form (best of two in turns): {no_slower}; "
          f"cuda_backend.VECTOR_DEFAULT = {cuda_backend.VECTOR_DEFAULT}")

    sw_st = sw[(True, "vector")].stencil
    form = "vector_ms" if cuda_backend.VECTOR_DEFAULT else "scalar_ms"
    kernels.append({
        "name": sw_st.name,
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
        "replaces": REPLACES["rows"] + "; " + REPLACES["wrap"],
        "launches": vlaunch["sw step_fn"] + vlaunch["sw local_step_fn"],
        "max_abs_err": sw_err,
        "ms": min(forms[sw_st.name][form]),
        "plain_ms": paths["sw step_fn"]["plain_ms"],
        **_bound(sw_st.analysis, (NI, NJ, NK)),
        "vector_ms": min(forms[sw_st.name]["vector_ms"]),
        "scalar_ms": min(forms[sw_st.name]["scalar_ms"]),
    })
    kernels.append({
        "name": "K6 row-phase staging: hdiff_float32's tile kernel on tight halo-3 buffers "
                "(16-byte cp.async from each row's aligned-down word, no repair copy)",
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py; "
                  "gt4py_tpu_torch/csrc/stencil_runtime.cuh",
        "replaces": REPLACES["repair"],
        "launches": sum(vlaunch.values()),
        "max_abs_err": err,
        "ms": min(hd_ms["default"]),
        "plain_ms": hd_plain,
        **_bound(an, (NI, NJ, NK)),
        "device_ms": tiles["hdiff tight bounded"]["tile_device_ms"],
        "aligned_device_ms": tiles["hdiff aligned periodic"]["tile_device_ms"],
        "tight_device_ms": {k: v["tile_device_ms"] for k, v in tiles.items()},
        "repair_ms": min(hd_ms["repair"]),
        "copy_ms": min(hd_ms["copies"]),
        "repair_bytes": rplan["repair_bytes"],
        "vector_launches": vlaunch,
    })
    return {"paths": paths, "md_tight_step_ms": md_steps, "fv_tight_step_ms": fv_steps,
            "hdiff_tight_ms": hd_ms, "forms": forms, "vector_no_slower": no_slower,
            "vector_default": cuda_backend.VECTOR_DEFAULT, "spectral": spec,
            "tight_tiles": tiles, "copy_bytes_per_s": copy_rate}


def _phase11_models(dev) -> dict:
    """Phase 11's models and stencils (float32 at 512x512x80 unless noted)."""
    import numpy as np

    from gt4py_tpu_torch.models import dycore, fv_advection, semi_lagrangian
    from gt4py_tpu_torch.models.shallow_water import ShallowWater

    shape = (NI, NJ, NK)
    f32 = dict(dtype=np.float32, device=dev)
    p11 = {
        "repair_defs": {(name, dtype): pair for dtype in (np.float32, np.float64)
                        for name, pair in _repair_defs(dtype).items()},
        "sw": {(aligned, form): ShallowWater(*shape, **f32, aligned=aligned,
                                             options={"vector": form == "vector"})
               for aligned in (True, False) for form in ("vector", "scalar")},
        "sw_plain": {aligned: ShallowWater(*shape, **f32, aligned=aligned, backend="torch")
                     for aligned in (True, False)},
        "sw_f64": ShallowWater(*SMALL, dtype=np.float64, device=dev),
        "md_tight": {label: dycore.MiniDycore(*shape, **f32, aligned=False, options=opts)
                     for label, opts in (("default", {}),
                                         ("repair", {"vector": True, "repair": True}))},
        "md_tight_plain": dycore.MiniDycore(*shape, **f32, aligned=False, backend="torch"),
        "fv_tight": {label: fv_advection.FvAdvection(*shape, **f32, aligned=False, options=opts)
                     for label, opts in (("default", {}),
                                         ("repair", {"vector": True, "repair": True}))},
        "fv_tight_plain": fv_advection.FvAdvection(*shape, **f32, aligned=False,
                                                   backend="torch"),
    }
    # aligned periodic calls of every row-form stencil on the path, in the
    # vector and the scalar form: (name, {form: stencil}, call(stencil))
    md = dycore.MiniDycore(*shape, **f32, backend="torch")
    fv = fv_advection.FvAdvection(*shape, **f32, backend="torch")
    sw = p11["sw"][(True, "vector")]
    s = md.init_state(seed=0)
    f = fv.init_state(seed=0)
    h = sw.init_state()
    kw = dict(origin=(md.oi, md.oj, 0), domain=shape, physical_layout=True, periodic=("I", "J"))
    kw_sw = dict(kw, origin=(sw.oi, sw.oj, 0))

    def both(make):
        return {form: make(vector=form == "vector") for form in ("vector", "scalar")}

    p11["aligned_calls"] = [
        ("hdiff", both(lambda **o: dycore.make_hdiff(np.float32, "cuda", **o)),
         lambda st: st.functional(**kw)(in_field=s["u"], out_field=s["u"],
                                       coeff=s["coeff"])["out_field"]),
        ("fv_step", both(lambda **o: fv_advection.make_fv_step(np.float32, "cuda", **o)),
         lambda st: st.functional(**kw)(q=f["q"], cx=f["cx"], cy=f["cy"],
                                       qout=f["q"].new_zeros(f["q"].shape))["qout"]),
        ("sl_step", both(lambda **o: semi_lagrangian.make_sl_stencil(np.float32, "cuda", 1,
                                                                     **o)),
         lambda st: st.functional(**kw)(q=f["q"], u=f["cx"], v=f["cy"],
                                       qout=f["q"].new_zeros(f["q"].shape), dtdx=1.0,
                                       dtdy=1.0)["qout"]),
        ("sw_step", {form: p11["sw"][(True, form)].stencil for form in ("vector", "scalar")},
         lambda st: st.functional(**kw_sw)(h=h["h"], u=h["u"], v=h["v"],
                                          h_new=h["h"].new_zeros(h["h"].shape),
                                          u_new=h["h"].new_zeros(h["h"].shape),
                                          v_new=h["h"].new_zeros(h["h"].shape))["h_new"]),
    ]
    return p11


def _phase11_stencils(p11) -> list:
    out = [pair["cuda"] for pair in p11["repair_defs"].values()]
    out += [m.stencil for m in p11["sw"].values()] + [p11["sw_f64"].stencil]
    for m in p11["md_tight"].values():
        out += [m.hdiff, m.vadv_upd, m.fused]
    out += [m.fv_step for m in p11["fv_tight"].values()]
    out += [st for _, pair, _ in p11["aligned_calls"] for st in pair.values()]
    return out


# --------------------------------------------------------------------------- #
# phase 12
# --------------------------------------------------------------------------- #

#: phase 12: the stencils whose PARALLEL sections run the tile form (K1) and
#: whose serial loops run the fused column kernel (K2), the forms their
#: new build must run (from ``LAST_PLAN``) and the kernels the library
#: counts a call (the fused MiniDycore stencil's: ``_mixed_default``)
P12_FORMS = {"hdiff": (["tile"], 1), "fv_step": (["tile"], 1), "sw_step": (["tile"], 1),
             "sl_step": (["tile"], 1), "vadv_update": (["column"], 1),
             "dycore_fused": None}


def _mixed_default():
    """The fused MiniDycore stencil's default forms and kernels a call:
    the sweep form (one kernel) or the split build (``SERIALIZE_MIXED``)."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    return (["sweep"], 1) if cuda_backend.SERIALIZE_MIXED else (["tile", "column"], 2)
#: the split build each is held against: the stage-split row kernels, the
#: per-loop column kernels
P12_SPLIT = {"hdiff": {"tiles": False}, "fv_step": {"tiles": False},
             "sw_step": {"tiles": False}, "sl_step": {"tiles": False},
             "vadv_update": {"fuse_loops": False},
             "dycore_fused": {"fuse_loops": False, "tiles": False}}
#: the new build's options where it is not the default: sl_step's one
#: stage runs the row kernel by default (``cuda_backend.ONE_STAGE``)
P12_NEW = {"sl_step": {"tiles": True}}
#: the default forms of the FullDycore step's stencils: hdiff, vadv_update,
#: fv_step and the semi-Lagrangian step
P12_DEFAULT_FORMS = (["tile"], ["column"], ["tile"], ["rows"])
P12_PAIRS = 3


def _p12_factories(models):
    """name -> (factory(dtype, backend, **options), model key, args(state, zeros))."""
    from gt4py_tpu_torch.models import dycore, fv_advection, semi_lagrangian, shallow_water

    sw_params = models["sw"].params
    return {
        "hdiff": (dycore.make_hdiff, "md",
                  lambda s, z: dict(in_field=s["u"], out_field=s["u"], coeff=s["coeff"])),
        "vadv_update": (dycore.make_vadv_update, "md",
                        lambda s, z: dict(utens_stage=s["utens_stage"], u_stage=s["u"],
                                          wcon=s["wcon"], u_pos=s["u"], utens=s["utens"],
                                          u_out=z(s["u"]), dtr_stage=3.0)),
        "dycore_fused": (dycore.make_dycore_fused, "md",
                         lambda s, z: dict(u=s["u"], coeff=s["coeff"], wcon=s["wcon"],
                                           utens=s["utens"], utens_stage=s["utens_stage"],
                                           u_out=z(s["u"]), dtr_stage=3.0)),
        "fv_step": (fv_advection.make_fv_step, "fv",
                    lambda s, z: dict(q=s["q"], cx=s["cx"], cy=s["cy"], qout=z(s["q"]))),
        "sl_step": (lambda dt, b, **o: semi_lagrangian.make_sl_stencil(dt, b, 1, **o), "fv",
                    lambda s, z: dict(q=s["q"], u=s["cx"], v=s["cy"], qout=z(s["q"]),
                                      dtdx=1.0, dtdy=1.0)),
        "sw_step": (lambda dt, b, **o: shallow_water.make_sw_step(dt, b, **sw_params, **o),
                    "sw", lambda s, z: dict(h=s["h"], u=s["u"], v=s["v"], h_new=z(s["h"]),
                                            u_new=z(s["h"]), v_new=z(s["h"]))),
    }


def _phase12_builds(dev) -> dict:
    """Phase 12's stencils: per shape key and name, the new build (the tile
    form or the fused column kernel), the split build and plain; the models whose states and origins they take."""
    import numpy as np

    from gt4py_tpu_torch.models import dycore, fv_advection
    from gt4py_tpu_torch.models.shallow_water import ShallowWater

    out = {}
    for key, (shape, dtype) in {"f32": ((NI, NJ, NK), np.float32),
                                "f64": (SMALL, np.float64)}.items():
        models = {"md": dycore.MiniDycore(*shape, dtype=dtype, backend="torch", device=dev),
                  "fv": fv_advection.FvAdvection(*shape, dtype=dtype, backend="torch",
                                                 device=dev),
                  "sw": ShallowWater(*shape, dtype=dtype, backend="torch", device=dev)}
        builds = {}
        for name, (make, mkey, args) in _p12_factories(models).items():
            builds[name] = {"tile": make(dtype, "cuda", **P12_NEW.get(name, {})),
                            "split": make(dtype, "cuda", **P12_SPLIT[name]),
                            "plain": make(dtype, "torch"), "model": mkey, "args": args}
        out[key] = {"shape": shape, "models": models, "builds": builds}
    return out


def _phase12_stencils(p12) -> list:
    return [b[form] for c in p12.values() for b in c["builds"].values()
            for form in ("tile", "split")]


def _phase12(p12, fd, dev) -> dict:
    """Phase 12: each stencil in its new build (tile form, fused column
    kernel) against its split build and plain, bit for bit, periodic and
    bounded, at 512x512x80 float32 and 64x256x16 float64; its forms from
    ``LAST_PLAN`` and its kernel launches from its library; then each timed
    one call at a time and in back-to-back pairs against the split build,
    with device time per kernel (every launch in the profile); and the
    FullDycore step's device breakdown, its stencils' default forms checked."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    result = {"checks": [], "timings": {}, "launches": {}, "max_abs_err": {}}
    for key, c in p12.items():
        shape = c["shape"]
        for name, b in c["builds"].items():
            m = c["models"][b["model"]]
            state = m.init_state(seed=5) if b["model"] != "sw" else m.init_state()
            kw = dict(origin=(m.oi, m.oj, 0), domain=shape, physical_layout=True)
            for periodic in (("I", "J"), ()):
                fns = {form: b[form].functional(**kw, periodic=periodic)
                       for form in ("tile", "split", "plain")}
                args = b["args"](state, torch.zeros_like)
                got = {}
                for form in ("tile", "split", "plain"):
                    st = b[form]
                    before = st.backend.device_launches()["all"] if form != "plain" else 0
                    got[form] = fns[form](**args)
                    torch.cuda.synchronize()
                    if form == "tile":
                        counted = st.backend.device_launches()["all"] - before
                        plan = LAST_PLAN[st.name]
                        forms, launches = P12_FORMS[name] or _mixed_default()
                        if plan["forms"] != forms or counted != launches or plan["kblocked"] \
                                or "tiles" in plan["declined"] \
                                or "fuse_loops" in plan["declined"]:
                            raise AssertionError(
                                f"phase 12 {name} {key} {periodic}: forms {plan['forms']}, "
                                f"{counted} kernels counted, declined {plan['declined']}; "
                                f"want {forms}, {launches}")
                if key == "f32":
                    result["launches"][name] = result["launches"].get(name, 0) + counted
                    result["max_abs_err"][name] = max(
                        [result["max_abs_err"].get(name, 0.0)]
                        + [_errors(t, got["plain"][f])[0] for f, t in got["tile"].items()])
                for form in ("split", "plain"):
                    for field, t in got["tile"].items():
                        if not torch.equal(t, got[form][field]):
                            _check_close(f"phase 12 {name}.{field} vs {form}", t,
                                         got[form][field], RTOL_F64, ATOL_F64)
                            raise AssertionError(f"phase 12 {name}.{field} {key} {periodic}: "
                                                 f"the new build and {form} differ")
                result["checks"].append(f"{name} {key} {'periodic' if periodic else 'bounded'}")
                if key == "f32" and periodic:
                    result.setdefault("plans", {})[name] = plan
                print(f"phase 12 {name} {key} {shape} {'periodic' if periodic else 'bounded'}: "
                      f"forms {plan['forms']}, {counted} kernel launches counted, bitwise equal "
                      f"to the split build and plain; tiles {plan['tiles']}, columns "
                      f"{plan['columns']}, 16-byte words of {plan.get('vector')} elements")
            if key != "f32":
                continue
            fns = {form: b[form].functional(**kw, periodic=("I", "J"))
                   for form in ("tile", "split", "plain")}
            args = b["args"](state, torch.zeros_like)
            calls = {form: (lambda f=fns[form]: f(**args)) for form in fns}
            t = {"ms": [], "split_ms": []}
            for _ in range(2):
                t["ms"].append(_time_ms(calls["tile"], TIMING_REPS))
                t["split_ms"].append(_time_ms(calls["split"], TIMING_REPS))
            t["b2b_pairs_ms"] = [(_time_b2b_ms(calls["tile"], BACK_TO_BACK)[0],
                                  _time_b2b_ms(calls["split"], BACK_TO_BACK)[0])
                                 for _ in range(P12_PAIRS)]
            t["plain_ms"] = _time_ms(calls["plain"], PLAIN_TIMING_REPS)
            for form in ("tile", "split"):
                st = b[form]
                total, rows = _device_ms(
                    calls[form], counted=[(st.name, lambda st=st: st.backend.device_launches()["all"])])
                kern = {k: v for k, v in rows.items() if b[form].name in k}
                t[f"{form}_device_ms"] = total
                t[f"{form}_kernels"] = {k: [round(ms, 6), n] for k, (ms, n) in kern.items()}
            t["won_pairs"] = sum(a < s for a, s in t["b2b_pairs_ms"])
            t["bound"] = _bound(b["tile"].analysis, shape)
            t["plan"] = result["plans"][name]
            t["ptxas"] = _ptxas(b["tile"])
            result["timings"][name] = t
            print(f"phase 12 {name} {NI}x{NJ}x{NK} f32: new {t['ms'][0]:.4f} / "
                  f"{t['ms'][1]:.4f} ms, split {t['split_ms'][0]:.4f} / {t['split_ms'][1]:.4f} "
                  f"ms (one call at a time, in turns); back to back (new, split) "
                  f"{[(round(a, 4), round(s, 4)) for a, s in t['b2b_pairs_ms']]}: the new build "
                  f"won {t['won_pairs']} of {P12_PAIRS}; device {t['tile_device_ms']} / "
                  f"{t['split_device_ms']} ms, kernels {t['tile_kernels']} / "
                  f"{t['split_kernels']}; plain {t['plain_ms']:.4f} ms; bound "
                  f"{t['bound']['bound_ms']:.4f} ms; {t['ptxas']}")
    # the FullDycore step's device time by kernel, 20 steps back to back;
    # the profile holds every launch of its stencils
    fstate = fd.init_state(seed=0)
    fstep = fd.step_fn()
    fsts = [fd.dyn.hdiff, fd.dyn.vadv_upd, fd.fv.fv_step, fd.sl]
    total, rows = _device_ms(lambda: fstep(fstate), counted=[
        (st.name, lambda st=st: st.backend.device_launches()["all"]) for st in fsts])
    forms = {st.name: LAST_PLAN[st.name]["forms"] for st in fsts}
    if forms != dict(zip([st.name for st in fsts], P12_DEFAULT_FORMS)) \
            or LAST_PLAN[fd.sl.name]["declined"].get("tiles") != cuda_backend.ONE_STAGE:
        raise AssertionError(f"phase 12 FullDycore: forms {forms}, sl declined "
                             f"{LAST_PLAN[fd.sl.name]['declined']}")
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])
    result["full_dycore"] = {"device_ms": total, "wall_b2b_ms": _time_chain_ms(fstep, fstate,
                                                                               BACK_TO_BACK),
                             "forms": forms,
                             "kernels": {k: [round(ms, 6), n] for k, (ms, n) in top[:16]}}
    print(f"phase 12 FullDycore {NI}x{NJ}x{NK} f32 step: device {total} ms, back to back "
          f"{result['full_dycore']['wall_b2b_ms']:.4f} ms; by kernel "
          f"{result['full_dycore']['kernels']}")
    return result


def tiles_only() -> int:
    """``--tiles``: phase 12 alone (the build, the checks, the timings)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gt4py_tpu_torch.models import full_dycore
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"card: {smi}")
    p12 = _phase12_builds(dev)
    fd = full_dycore.FullDycore(NI, NJ, NK, dtype=np.float32, backend="cuda", device=dev)
    stencils = _phase12_stencils(p12) + [fd.dyn.hdiff, fd.dyn.vadv_upd, fd.fv.fv_step, fd.sl]
    t0 = time.perf_counter()
    n = build_all([st.backend for st in stencils])
    print(f"build: {n} sources, {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    result = _phase12(p12, fd, dev)
    print(smi)
    print(json.dumps({**result, "profile_losses": PROFILE_LOSSES}, default=str))
    return 1 if PROFILE_LOSSES else 0


#: ``--profile-check``: per variant (warm-up cycle, idle seconds at each
#: end); the profiles of each subject a variant, in turns; the seconds the
#: check waits after the first profile of its process
PROFILE_VARIANTS = {"plain": (False, 0.0), "idle": (False, 1.0), "warmup": (True, 0.0),
                    "warmup_idle": (True, PROFILE_PAD_S)}
PROFILE_CHECK_REPS = 3
PROFILE_AGE_S = 150.0


def _profile_check(dev, n=20, age_s=0.0) -> dict:
    """The device events a profile keeps of ``n`` calls of a 16 MiB add and
    of a K9 permute at 2^20 words (``PROFILE_VARIANTS``), against the
    launches made, ``age_s`` seconds after a first profile; for the add,
    where its kernels start against their launches (matched by
    correlation id), in us."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from gt4py_tpu_torch.next import benes

    x = torch.rand(1 << 22, device=dev)
    y = torch.empty_like(x)
    _, keys = _perm(1 << 20, 11)
    xp = torch.from_numpy(np.random.default_rng(12).random(1 << 20).astype(np.float32)).to(dev)
    benes.permute(xp, keys)
    torch.cuda.synchronize()
    subjects = {"add": (lambda: torch.add(x, 1.0, out=y), "add"),
                "k9": (lambda: benes.permute(xp, keys), "benes_pass")}
    if age_s:
        _profiled(subjects["add"][0], n)
        time.sleep(age_s)
    out = {}
    for _ in range(PROFILE_CHECK_REPS):
        for variant, (warmup, pad) in PROFILE_VARIANTS.items():
            for subject, (fn, part) in subjects.items():
                fn()
                torch.cuda.synchronize()
                c0 = benes.KERNEL.device_launches
                prof = _profiled(fn, n, warmup, pad)
                made = n if subject == "add" else \
                    (benes.KERNEL.device_launches - c0) // (2 if warmup else 1)
                events = list(prof.events())
                device = [e for e in events if e.device_type == DeviceType.CUDA]
                kern = [e for e in device if part in e.name]
                rec = out.setdefault(f"{subject} {variant}", {"seen": [], "made": made})
                rec["seen"].append(len(kern))
                for e in device:
                    if part not in e.name:
                        others = rec.setdefault("other_device_events", {})
                        others[e.name[:60]] = others.get(e.name[:60], 0) + 1
                if subject == "add":
                    launch = {e.id: e for e in events if e.device_type == DeviceType.CPU
                              and e.name.startswith("cudaLaunchKernel")}
                    offs = [k.time_range.start - launch[k.id].time_range.start for k in kern
                            if k.id in launch]
                    rec.setdefault("kernel_minus_launch_us", []).append(
                        [round(min(offs), 1), round(max(offs), 1)] if offs else None)
    for key, rec in out.items():
        print(f"profile check {key}: {rec}")
    return {"variants": out, "calls": n, "age_s": age_s,
            "process_age_s": time.time() - T_START}


def profile_check() -> int:
    """``--profile-check``: ``_profile_check`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = _nvidia_smi()
    print(f"card: {smi}")
    out = _profile_check(torch.device("cuda", 0), age_s=PROFILE_AGE_S)
    print(smi)
    print(json.dumps({"profile_check": out}))
    return 0


#: ``--tile-sweep``: the tile form's tiles and levels a CTA, timed on the
#: stencils it runs by default
TILE_SWEEP = {"tiles": ((16, 32), (32, 32), (32, 64)), "kz": (4, 8, 16)}


def tile_sweep() -> int:
    """``--tile-sweep``: hdiff, fv_step and sw_step at 512x512x80 float32,
    periodic, built in the tile form at each (TI, TJ) of ``TILE_SWEEP``
    and each number of levels a CTA, each bitwise against plain, timed by
    device time (``torch.profiler``) and back to back."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.models import dycore, fv_advection
    from gt4py_tpu_torch.models.shallow_water import ShallowWater
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    shape = (NI, NJ, NK)
    models = {"md": dycore.MiniDycore(*shape, backend="torch", device=dev),
              "fv": fv_advection.FvAdvection(*shape, backend="torch", device=dev),
              "sw": ShallowWater(*shape, backend="torch", device=dev)}
    factories = _p12_factories(models)
    saved = (cuda_backend.TILE_SHAPES, cuda_backend.TILE_KZ)
    builds, declined = {}, {}
    try:
        for name in ("hdiff", "fv_step", "sw_step"):
            make = factories[name][0]
            for tile in TILE_SWEEP["tiles"]:
                for kz in TILE_SWEEP["kz"]:
                    cuda_backend.TILE_SHAPES, cuda_backend.TILE_KZ = (tile,), kz
                    try:
                        builds[(name, tile, kz)] = make(np.float32, "cuda", rebuild=True,
                                                        tiles=True)
                    except NotImplementedError as e:
                        declined[f"{name} {tile} kz {kz}"] = str(e)
    finally:
        cuda_backend.TILE_SHAPES, cuda_backend.TILE_KZ = saved
    t0 = time.perf_counter()
    n = build_all([st.backend for st in builds.values()])
    print(f"card: {smi}; build: {n} sources, {time.perf_counter() - t0:.2f} s")
    out = {}
    for (name, tile, kz), st in builds.items():
        make, mkey, args = factories[name]
        m = models[mkey]
        state = m.init_state(seed=5) if mkey != "sw" else m.init_state()
        kw = dict(origin=(m.oi, m.oj, 0), domain=shape, physical_layout=True,
                  periodic=("I", "J"))
        fn, ref_fn = st.functional(**kw), make(np.float32, "torch").functional(**kw)
        a = args(state, torch.zeros_like)
        got, ref = fn(**a), ref_fn(**a)
        if any(not torch.equal(v, ref[k]) for k, v in got.items()):
            raise AssertionError(f"tile sweep {name} {tile} kz {kz}: kernels and plain differ")
        (rec,) = st.backend.program.plan_record()["tiles"]
        _, rows = _device_ms(lambda: fn(**a))
        dev_ms = sum(ms for k, (ms, _) in rows.items() if "_tile(" in k)
        b2b = _time_b2b_ms(lambda: fn(**a), BACK_TO_BACK)[0]
        out[f"{name} {tile[0]}x{tile[1]} kz {kz}"] = {
            "device_ms": dev_ms, "b2b_ms": b2b, "smem_bytes": rec["smem_bytes"],
            "ctas_per_sm": rec["ctas_per_sm"], "slots": rec["slots"], "halo": rec["halo"],
            "ptxas": _ptxas(st)}
        print(f"tile sweep {name} {tile} kz {kz}: device {dev_ms:.4f} ms, back to back "
              f"{b2b:.4f} ms; {rec['smem_bytes']} shared bytes, {rec['ctas_per_sm']} CTAs a SM, "
              f"halo {rec['halo']}; bitwise equal to plain; {_ptxas(st)}")
    print(smi)
    print(json.dumps({"tile_sweep": out, "declined": declined, "card": smi}))
    return 0


#: ``--k6-k5`` and phases 4 and 11: the tile kernels held on tight buffers
#: (``aligned=False``: halo 3, halo 2 for sw_step) against the models'
#: aligned ones, and the back-to-back pairs of the fused MiniDycore step's
#: default build against its split build (``serialize=False``)
TIGHT_TILES = ("hdiff", "fv_step", "sw_step", "sl_step")
SWEEP_PAIRS = 5
#: the tile kernels' device ms on tight buffers, bounded, with element
#: copies at every row phase, as the tree before row-phase staging ran
#: them: the first run of ``--k6-k5 tight`` on that tree, NVIDIA H100 80GB
#: HBM3, 700.00 W (PERF.md, K6's starting point)
PARENT_ELEMENT_COPY_MS = {"hdiff": 0.2036, "fv_step": 1.0511, "sw_step": 0.2581}


def _tight_builds() -> dict:
    """``_tight_tiles``' stencils: name -> (default build, plain), and the
    models (aligned, tight) whose states and origins they take."""
    import numpy as np

    from gt4py_tpu_torch.models import dycore, fv_advection
    from gt4py_tpu_torch.models.shallow_water import ShallowWater

    shape = (NI, NJ, NK)
    layouts = {}
    for aligned in (True, False):
        layouts[aligned] = {
            "md": dycore.MiniDycore(*shape, backend="torch", device="cuda", aligned=aligned),
            "fv": fv_advection.FvAdvection(*shape, backend="torch", device="cuda",
                                           aligned=aligned),
            "sw": ShallowWater(*shape, backend="torch", device="cuda", aligned=aligned)}
    factories = _p12_factories(layouts[True])
    return {"layouts": layouts, "factories": factories,
            "builds": {name: (factories[name][0](np.float32, "cuda"),
                              factories[name][0](np.float32, "torch")) for name in TIGHT_TILES}}


def _tight_tiles(tb) -> dict:
    """K6 on the card: hdiff, fv_step and sw_step at 512x512x80 float32 in
    their default build, on the models' aligned buffers (periodic) and on
    tight ones (bounded and periodic): each call bitwise against plain, its
    tile kernel's device time (``torch.profiler``), the kernels and copies
    the call launched, and its staging and repair from ``LAST_PLAN``."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    shape = (NI, NJ, NK)
    out = {}
    for name, (st, plain) in tb["builds"].items():
        _, mkey, args = tb["factories"][name]
        for label, aligned, periodic in (("aligned periodic", True, ("I", "J")),
                                         ("tight bounded", False, ()),
                                         ("tight periodic", False, ("I", "J"))):
            m = tb["layouts"][aligned][mkey]
            state = m.init_state(seed=5) if mkey != "sw" else m.init_state()
            kw = dict(origin=(m.oi, m.oj, 0), domain=shape, physical_layout=True,
                      periodic=periodic)
            fn, ref_fn = st.functional(**kw), plain.functional(**kw)
            a = args(state, torch.zeros_like)
            before = st.backend.device_launches()["all"]
            got, ref = fn(**a), ref_fn(**a)
            torch.cuda.synchronize()
            counted = st.backend.device_launches()["all"] - before
            if any(not torch.equal(v, ref[k]) for k, v in got.items()):
                raise AssertionError(f"{name} {label}: kernels and plain differ")
            plan = LAST_PLAN[st.name]
            if "repair" in plan or counted != 1:
                raise AssertionError(f"{name} {label}: {counted} kernels counted, plan {plan}")
            total, rows = _device_ms(lambda: fn(**a), counted=[
                (st.name, lambda: st.backend.device_launches()["all"])])
            tile_ms = sum(ms for k, (ms, _) in rows.items() if st.name in k)
            rec = {"buffers": list(m.field_shape()), "tile_device_ms": tile_ms,
                   "call_device_ms": total,
                   "kernels": {k: [round(ms, 6), n] for k, (ms, n) in rows.items()},
                   "launches_counted": counted, "one_call_ms": _time_ms(lambda: fn(**a),
                                                                        TIMING_REPS),
                   "forms": plan["forms"], "staging": plan.get("staging"),
                   "repair": plan.get("repair"), "declined": plan["declined"]}
            out[f"{name} {label}"] = rec
            print(f"tight tiles {name} {NI}x{NJ}x{NK} f32 {label} (buffers {m.field_shape()}): "
                  f"bitwise equal to plain; tile kernel {tile_ms:.4f} ms of device time, the "
                  f"call {total:.4f}; {counted} kernels counted; staging {rec['staging']}, "
                  f"repair {rec['repair']}; one call {rec['one_call_ms']:.4f} ms; {_ptxas(st)}")
        tight = out[f"{name} tight bounded"]["tile_device_ms"]
        aligned_ms = out[f"{name} aligned periodic"]["tile_device_ms"]
        print(f"tight tiles {name}: tight bounded {tight:.4f} against aligned "
              f"{aligned_ms:.4f} ms ({100 * (tight / aligned_ms - 1):+.1f} %); with element "
              f"copies (before row-phase staging; PERF.md, K6) "
              f"{PARENT_ELEMENT_COPY_MS.get(name)} ms")
    return out


def _sweep_builds() -> dict:
    """``_sweep_pairs``' stencils: the fused MiniDycore stencil in the sweep
    form (``sweep=True``), in the plane-sweep form it replaces
    (``serialize=True``), split (``serialize=False``), and
    plain."""
    import numpy as np

    from gt4py_tpu_torch.models import dycore

    return {"sweep": dycore.make_dycore_fused(np.float32, "cuda", sweep=True),
            "planes": dycore.make_dycore_fused(np.float32, "cuda", serialize=True),
            "split": dycore.make_dycore_fused(np.float32, "cuda", serialize=False),
            "plain": dycore.make_dycore_fused(np.float32, "torch")}


def _sweep_pairs(sts) -> dict:
    """The fused MiniDycore stencil at 512x512x80 float32, periodic, in the
    forms of ``_sweep_builds``: each bitwise against plain, the launches
    its library counts, device time by kernel, one call at a time, and
    ``SWEEP_PAIRS`` back-to-back pairs (sweep, split): the pairs behind
    ``cuda_backend.SERIALIZE_MIXED``."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN
    from gt4py_tpu_torch.models import dycore

    shape = (NI, NJ, NK)
    m = dycore.MiniDycore(*shape, backend="torch", device="cuda")
    state = m.init_state(seed=5)
    kw = dict(origin=(m.oi, m.oj, 0), domain=shape, physical_layout=True, periodic=("I", "J"))
    a = dict(u=state["u"], coeff=state["coeff"], wcon=state["wcon"], utens=state["utens"],
             utens_stage=state["utens_stage"], u_out=torch.zeros_like(state["u"]),
             dtr_stage=3.0)
    ref = sts["plain"].functional(**kw)(**a)
    fns = {label: st.functional(**kw) for label, st in sts.items() if label != "plain"}
    out = {}
    for label, fn in fns.items():
        st = sts[label]
        before = st.backend.device_launches()["all"]
        got = fn(**a)
        torch.cuda.synchronize()
        counted = st.backend.device_launches()["all"] - before
        if any(not torch.equal(v, ref[k]) for k, v in got.items()):
            raise AssertionError(f"dycore_fused {label}: kernels and plain differ")
        plan = LAST_PLAN[st.name]
        total, rows = _device_ms(lambda f=fn: f(**a), counted=[
            (st.name, lambda st=st: st.backend.device_launches()["all"])])
        out[label] = {"forms": plan["forms"], "launches_counted": counted,
                      "call_device_ms": total,
                      "kernel_device_ms": sum(ms for k, (ms, _) in rows.items() if st.name in k),
                      "kernels": {k: [round(ms, 6), n] for k, (ms, n) in rows.items()},
                      "one_call_ms": _time_ms(lambda f=fn: f(**a), TIMING_REPS),
                      "sweep": plan.get("sweep"), "ptxas": _ptxas(st)}
        print(f"dycore_fused {NI}x{NJ}x{NK} f32 {label}: forms {plan['forms']}, {counted} "
              f"kernels counted, bitwise equal to plain; its kernels "
              f"{out[label]['kernel_device_ms']:.4f} ms of device time (the call {total:.4f}); "
              f"one call {out[label]['one_call_ms']:.4f} ms; sweep {plan.get('sweep')}; "
              f"{out[label]['ptxas']}")
    if out["sweep"]["forms"] != ["sweep"] or out["sweep"]["launches_counted"] != 1:
        raise AssertionError(f"dycore_fused sweep=True: {out['sweep']}")
    pairs = []
    for n in range(SWEEP_PAIRS):
        order = ("sweep", "split") if n % 2 == 0 else ("split", "sweep")
        t = {label: _time_b2b_ms(lambda f=fns[label]: f(**a), BACK_TO_BACK)[0] for label in order}
        pairs.append((t["sweep"], t["split"]))
    out["b2b_pairs_ms"] = pairs
    out["sweep_won"] = sum(w < s for w, s in pairs)
    print(f"dycore_fused back to back (sweep, split), alternating which runs first: "
          f"{[(round(w, 4), round(s, 4)) for w, s in pairs]}: the sweep won {out['sweep_won']} of "
          f"{SWEEP_PAIRS}")
    return out


#: ``--k6-k5``: the sweep kernel's tiles timed against each other
SWEEP_TILE_SWEEP = ((8, 32), (16, 32), (4, 64), (4, 32), (8, 64))


def _sweep_tile_builds() -> dict:
    """The fused MiniDycore stencil in the sweep form at each tile of
    ``SWEEP_TILE_SWEEP``."""
    import numpy as np

    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.models import dycore

    saved = cuda_backend.SWEEP_TILES
    out = {}
    try:
        for tile in SWEEP_TILE_SWEEP:
            cuda_backend.SWEEP_TILES = (tile,)
            out[tile] = dycore.make_dycore_fused(np.float32, "cuda", sweep=True, rebuild=True)
    finally:
        cuda_backend.SWEEP_TILES = saved
    return out


def _sweep_tile_times(builds) -> dict:
    """Each sweep tile's device time at 512x512x80 float32, periodic,
    bitwise against plain."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.models import dycore

    m = dycore.MiniDycore(NI, NJ, NK, backend="torch", device="cuda")
    state = m.init_state(seed=5)
    kw = dict(origin=(m.oi, m.oj, 0), domain=(NI, NJ, NK), physical_layout=True,
              periodic=("I", "J"))
    a = dict(u=state["u"], coeff=state["coeff"], wcon=state["wcon"], utens=state["utens"],
             utens_stage=state["utens_stage"], u_out=torch.zeros_like(state["u"]),
             dtr_stage=3.0)
    ref = dycore.make_dycore_fused(np.float32, "torch").functional(**kw)(**a)
    out = {}
    for tile, st in builds.items():
        fn = st.functional(**kw)
        got = fn(**a)
        if any(not torch.equal(v, ref[k]) for k, v in got.items()):
            raise AssertionError(f"sweep tile {tile}: kernels and plain differ")
        _, rows = _device_ms(lambda: fn(**a), counted=[
            (st.name, lambda: st.backend.device_launches()["all"])])
        rec = st.backend.program.plan_record()["sweep"][0]
        out[f"{tile[0]}x{tile[1]}"] = {
            "device_ms": sum(ms for k, (ms, _) in rows.items() if "_sweep(" in k),
            "smem_bytes": rec["smem_bytes"], "ctas_per_sm": rec["ctas_per_sm"],
            "halo": rec["halo"], "ptxas": _ptxas(st)}
        print(f"sweep tile {tile}: {out[f'{tile[0]}x{tile[1]}']}")
    return out


def k6_k5(tight_only=False) -> int:
    """``--k6-k5``: the tight tile kernels (``_tight_tiles``), the fused
    step's forms and pairs (``_sweep_pairs``) and the sweep kernel's tiles
    (``SWEEP_TILE_SWEEP``), alone; ``--k6-k5 tight``: the first alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.next.compiled_program import build_all

    smi = _nvidia_smi()
    print(f"card: {smi}")
    tb = _tight_builds()
    sts, tiles = ({}, {}) if tight_only else (_sweep_builds(), _sweep_tile_builds())
    build_all([st.backend for st, _ in tb["builds"].values()]
              + [st.backend for label, st in sts.items() if label != "plain"]
              + [st.backend for st in tiles.values()])
    result = {"tight": _tight_tiles(tb)}
    if not tight_only:
        result.update(sweep=_sweep_pairs(sts), sweep_tiles=_sweep_tile_times(tiles))
    print(smi)
    print(json.dumps({**result, "profile_losses": PROFILE_LOSSES, "card": smi}, default=str))
    return 1 if PROFILE_LOSSES else 0


# --------------------------------------------------------------------------- #
# the K3 phase: variable and absolute K
# --------------------------------------------------------------------------- #

#: case -> the stencil it runs (registry or ``testing.SURFACE``) at
#: 512x512x80 float64; "wide" draws idx over the whole column, [-80, 80]
K3_CASES = {"narrow": "variable_k_offset", "wide": "variable_k_offset",
            "at_k_field": "at_k_field", "variable_k_in_scan": "variable_k_in_scan",
            "at_k_in_scan": "at_k_in_scan"}
#: the staged form against its parent (``stage_vark=False``) in device-time
#: turns: parent, staged, staged, parent, this many times
K3_PAIRS = 3


def _k3_builds() -> dict:
    """Each K3 case's stencils: the default build (``change``), for the
    staged form's cases its parent form (``stage_vark=False``), and plain."""
    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian import gtscript

    registry = testing.load_stencil_defs()
    defs = {"variable_k_offset": testing.registry_case(registry["variable_k_offset"]),
            **{n: testing.SURFACE[n] for n in K3_CASES.values() if n in testing.SURFACE}}
    out = {}
    for case, name in K3_CASES.items():
        d, make_inputs, kw = defs[name]
        forms = {"change": {}}
        if name == "variable_k_offset":
            forms = {"parent": {"stage_vark": False}, "change": {}}
        out[case] = {"name": name, "make_inputs": make_inputs, "origin": kw.get("origin", _ZERO),
                     "sts": {label: gtscript.stencil(backend="cuda", definition=d, rebuild=True,
                                                     **opts) for label, opts in forms.items()},
                     "plain": gtscript.stencil(backend="torch", definition=d, rebuild=True)}
    return out


def _k3_stencils(builds) -> list:
    return [st for b in builds.values() for st in b["sts"].values()]


def _kij_ints(lo, hi, seed, dev):
    """Integers in [lo, hi] at 512x512x80, laid out as ``_scaled_inputs``
    lays out its fields."""
    import numpy as np
    import torch

    a = np.random.default_rng(seed).integers(lo, hi + 1, (NK, NI, NJ)).astype(np.int64)
    return torch.from_numpy(a).to(dev).movedim(0, 2)


def _k3_min_bytes(analysis, shape) -> int:
    """``_min_bytes``, with a field read only at absolute levels whose index
    does not vary along K counted as the levels it reads, one plane each,
    and a field a serial loop writes and reads only behind its sweep, at
    (0, 0, dk), as written once and read at |dk| planes (the levels before
    the sweep's first)."""
    import numpy as np

    from gt4py_tpu_torch.cartesian import ir
    from gt4py_tpu_torch.cartesian.analysis import _stmt_reads, _stmt_writes

    st = analysis.stencil
    reads, behind = {}, {}
    for loop in st.vertical_loops:
        back = {ir.LoopOrder.FORWARD: -1, ir.LoopOrder.BACKWARD: 1}.get(loop.loop_order, 0)
        writes = {w.name for sec in loop.sections for s in sec.body for w in _stmt_writes(s)}
        for sec in loop.sections:
            for s in sec.body:
                for r in _stmt_reads(s):
                    reads.setdefault(r.name, []).append(r)
                    o = r.offset
                    ok = r.name in writes and isinstance(o, ir.CartesianOffset) and \
                        not (o.i or o.j) and o.k * back > 0
                    behind[r.name] = behind.get(r.name, True) and ok

    def invariant(e) -> bool:
        return not any(
            (isinstance(n, ir.FieldAccess) and st.decl(n.name).dimensions[2])
            or (isinstance(n, ir.AxisPosition) and n.axis == "K") for n in ir.walk_values(e))

    n = _min_bytes(analysis, shape)
    for name, rs in reads.items():
        info = analysis.field_info.get(name)
        if info is None:
            continue
        plane = shape[0] * shape[1] * np.dtype(info.dtype).itemsize
        if info.access.value & 2:
            if behind[name]:
                n -= plane * shape[2] - plane * max(abs(r.offset.k) for r in rs)
        elif all(isinstance(r.offset, ir.AbsoluteKIndex) and invariant(r.offset.k) for r in rs):
            n -= plane * shape[2] - plane * len({repr(r.offset.k) for r in rs})
    return n


def _k3(builds, dev) -> dict:
    """Each K3 case at 512x512x80 float64: every build's result against
    plain (bitwise, and within the float64 tolerance), the kernel launches
    its library counts a call, its reads outside the staged windows
    (``backend.outside_reads``), its device ms a launch in turns (parent,
    staged, staged, parent; ``K3_PAIRS`` times), one call at a time, its
    plan and registers, and the bound."""
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    out = {}
    for case, b in builds.items():
        tensors, scalars = _scaled_inputs(b["make_inputs"], (NI, NJ, NK), dev)
        if case == "wide":
            tensors["idx"] = _kij_ints(-NK, NK, 1, dev)
        plain = b["plain"]
        written = [k for k in tensors if plain.field_info[k].access.value & 2]
        origin = b["origin"]
        ref = {k: v.clone() if k in written else v for k, v in tensors.items()}
        plain(**ref, **scalars, origin=origin)
        res = {"stencil": b["name"], "forms": {}, "bitwise": {}, "max_abs_err": {},
               "launches_a_call": {}, "outside_reads": {}, "device_ms": {}, "one_call_ms": {},
               "registers": {}}
        calls = {}
        for label, st in b["sts"].items():
            args = {k: v.clone() if k in written else v for k, v in tensors.items()}
            st.backend.build()
            before = st.backend.device_launches()["all"]
            reads = getattr(st.backend, "outside_reads", dict)
            seen = sum(reads().values())
            st(**args, **scalars, origin=origin)
            torch.cuda.synchronize()
            res["launches_a_call"][label] = st.backend.device_launches()["all"] - before
            res["outside_reads"][label] = sum(reads().values()) - seen
            plan = LAST_PLAN[st.analysis.stencil.name]
            res["forms"][label] = {k: plan.get(k) for k in ("forms", "vark", "vector", "declined")}
            res["registers"][label] = _ptxas(st)
            res["bitwise"][label] = all(torch.equal(args[k], ref[k]) for k in written)
            res["max_abs_err"][label] = max(
                _check_close(f"K3 {case} {label} {k}", args[k], ref[k], RTOL_F64, ATOL_F64)[0]
                for k in written)
            # the call writes in place: repeated calls do the same work
            calls[label] = (st, lambda st=st, args=args: st(**args, **scalars, origin=origin))
        order = ["parent", "change", "change", "parent"] * K3_PAIRS if "parent" in calls \
            else ["change"] * (2 * K3_PAIRS)
        for label in order:
            st, call = calls[label]
            part = st.analysis.stencil.name
            _, rows = _device_ms(call, counted=[
                (part, lambda st=st: st.backend.device_launches()["all"])])
            own = [(ms, n) for k, (ms, n) in rows.items() if part in k]
            res["device_ms"].setdefault(label, []).append(
                sum(ms for ms, _ in own) / max(1.0, sum(n for _, n in own)))
        for label, (st, call) in calls.items():
            res["one_call_ms"][label] = _time_ms(call, TIMING_REPS)
        res["plain_ms"] = _time_ms(
            lambda: plain(**{k: v.clone() if k in written else v for k, v in tensors.items()},
                          **scalars, origin=origin), PLAIN_TIMING_REPS)
        res["bound_ms"] = _bound_ms(_k3_min_bytes(plain.analysis, (NI, NJ, NK)))
        best = min(res["device_ms"]["change"])
        print(f"K3 {case} ({b['name']}, 512x512x80 f64): device ms a launch "
              + ", ".join(f"{label} {[round(x, 4) for x in v]}"
                          for label, v in res["device_ms"].items())
              + f"; one call {res['one_call_ms']}; bound {res['bound_ms']:.4f} ms "
              f"({100 * res['bound_ms'] / best:.1f} % of it at {best:.4f}); launches a call "
              f"{res['launches_a_call']}; reads outside the windows {res['outside_reads']}; "
              f"bitwise equal to plain {res['bitwise']}; forms "
              f"{ {k: v['forms'] for k, v in res['forms'].items()} }; windows "
              f"{res['forms']['change']['vark']}; {res['registers']['change']}")
        if not all(res["bitwise"].values()):
            raise AssertionError(f"K3 {case}: a build differs from plain bit for bit: {res}")
        if any(n < 1 for n in res["launches_a_call"].values()):
            raise AssertionError(f"K3 {case}: no kernel launch counted: {res}")
        out[case] = res
    return out


def _k3_library(dev) -> dict:
    """One PyTorch call that computes K3's and K7's functions on the timed
    stencils' inputs at 512x512x80 float64, held bitwise to plain: K3's
    ``variable_k_offset`` as ``torch.gather`` along K with the clipped
    absolute level precomputed, K7's ``data_dims_dynamic_index`` as
    ``torch.gather`` along the data dimension plus the add, with ``idx % 3``
    precomputed; each timed one call at a time and by device time, and the
    index arithmetic beside it."""
    import torch

    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian import gtscript

    registry = testing.load_stencil_defs()
    out = {}
    for key, name in (("k3", "variable_k_offset"), ("k7", "data_dims_dynamic_index")):
        d, make_inputs, kw = testing.registry_case(registry[name])
        t, scalars = _scaled_inputs(make_inputs, (NI, NJ, NK), dev)
        plain = gtscript.stencil(backend="torch", definition=d, rebuild=True)
        ref = {**t, "out": t["out"].clone()}
        plain(**ref, **scalars, origin=kw.get("origin", _ZERO))
        if key == "k3":
            inp, idx = t["inp"].permute(2, 0, 1), t["idx"].permute(2, 0, 1)
            levels = torch.arange(NK, device=dev).view(NK, 1, 1)

            def index(idx=idx, levels=levels):
                return (levels + idx).clamp_(0, NK - 1)

            at = index()

            def call(inp=inp, at=at):
                return torch.gather(inp, 0, at)

            got = call().permute(1, 2, 0)
        else:
            vec, idx = t["vec"], t["idx"]

            def index(idx=idx):
                return torch.remainder(idx, 3).unsqueeze(3)

            at = index()

            def call(vec=vec, at=at):
                return torch.gather(vec, 3, at).squeeze(3) + vec[..., 1]

            got = call()
        if not torch.equal(got, ref["out"]):
            raise AssertionError(f"the library call for {name} differs from plain")
        out[key] = {"stencil": name, "call": "torch.gather" + (" + add" if key == "k7" else ""),
                    "one_call_ms": _time_ms(call, TIMING_REPS),
                    "device_ms": _device_ms(call)[0],
                    "index_one_call_ms": _time_ms(index, TIMING_REPS),
                    "index_device_ms": _device_ms(index)[0]}
        print(f"library {key} ({name}, 512x512x80 f64, bitwise equal to plain): "
              f"{out[key]['call']} {out[key]['one_call_ms']:.4f} ms one call at a time, "
              f"{out[key]['device_ms']:.4f} ms of device time; its index arithmetic "
              f"{out[key]['index_one_call_ms']:.4f} / {out[key]['index_device_ms']:.4f} ms")
    return out


#: ``--k3-tiles``: the staged form's (TI, TJ) columns and level lanes a CTA
K3_TILES = ((1, 32, 8), (1, 32, 4), (1, 32, 16), (2, 32, 4), (1, 64, 4))


def k3_tiles() -> int:
    """``--k3-tiles``: ``variable_k_offset``'s staged kernel at each of
    ``K3_TILES`` on the narrow and the wide offsets, device ms a launch,
    each result bitwise against plain; one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    d, make_inputs, _ = testing.registry_case(testing.load_stencil_defs()["variable_k_offset"])
    sts = {}
    saved = cuda_backend.VK_TILE, cuda_backend.VK_LANES
    for TI, TJ, LZ in K3_TILES:
        cuda_backend.VK_TILE, cuda_backend.VK_LANES = (TI, TJ), LZ
        try:
            sts[(TI, TJ, LZ)] = gtscript.stencil(backend="cuda", definition=d, rebuild=True)
        finally:
            cuda_backend.VK_TILE, cuda_backend.VK_LANES = saved
    plain = gtscript.stencil(backend="torch", definition=d, rebuild=True)
    build_all([st.backend for st in sts.values()])
    tensors, _ = _scaled_inputs(make_inputs, (NI, NJ, NK), dev)
    out = {}
    for case in ("narrow", "wide"):
        t = dict(tensors, idx=_kij_ints(-NK, NK, 1, dev)) if case == "wide" else tensors
        ref = dict(t, out=t["out"].clone())
        plain(**ref)
        for key, st in sts.items():
            args = dict(t, out=t["out"].clone())
            st(**args)
            if not torch.equal(args["out"], ref["out"]):
                raise AssertionError(f"K3 tile {key} {case}: differs from plain")
            part = st.analysis.stencil.name
            times = []
            for _ in range(2):
                _, rows = _device_ms(lambda st=st, args=args: st(**args), counted=[
                    (part, lambda st=st: st.backend.device_launches()["all"])])
                times.append(sum(ms for k, (ms, _) in rows.items() if part in k))
            plan = cuda_backend.LAST_PLAN[part]["vark"][0]
            out[f"{case} {key}"] = {"device_ms": times, "smem_bytes": plan["smem_bytes"],
                                    "ctas_per_sm": plan["ctas_per_sm"],
                                    "levels": plan["levels"], "registers": _ptxas(st)}
            print(f"K3 {case} tile {key}: {times} ms of device time a launch, {out[f'{case} {key}']}")
    print(smi)
    print(json.dumps({"k3_tiles": out, "card": smi, "profile_losses": PROFILE_LOSSES}))
    return 1 if PROFILE_LOSSES else 0


def k3_only() -> int:
    """``--k3``: the K3 phase alone (its builds, the cases, the library
    times); it also runs against an older tree's package, with this script
    copied there (``stage_vark`` unknown there: both builds the old form)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"card: {smi}")
    builds = _k3_builds()
    t0 = time.perf_counter()
    n = build_all([st.backend for st in _k3_stencils(builds)])
    print(f"build: {n} sources, {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    result = {"k3": _k3(builds, dev), "library": _k3_library(dev)}
    print(smi)
    print(json.dumps({**result, "profile_losses": PROFILE_LOSSES, "card": smi}, default=str))
    return 1 if PROFILE_LOSSES else 0


def k8_only() -> int:
    """``--k8``: phase 9 alone, without the routed FVM gradient: the
    FullDycore path's adjoint and tangent kernels against the plain
    backward, their device times and bounds."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.models import full_dycore
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"card: {smi}")
    models = {key: tuple(full_dycore.FullDycore(*shape, dtype=dtype, backend=b, device=dev)
                         for b in ("cuda", "torch"))
              for key, shape, dtype in (("f32", (NI, NJ, NK), np.float32),
                                        ("f64", SMALL, np.float64))}
    t0 = time.perf_counter()
    n = build_all([st.backend for fd, _ in models.values()
                   for st in (*_grad_path(fd).values(), fd.sl, fd.dyn.hdiff)]
                  + _derivative_builds(models))
    print(f"build: {n} sources, {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    result = _gradients(smi, models, None)
    print(smi)
    print(json.dumps({**result, "profile_losses": PROFILE_LOSSES, "card": smi}, default=str))
    return 1 if PROFILE_LOSSES else 0


#: ``--k8-tiles``: the tile shapes tried for the tile-form adjoints
K8_TILES = ((32, 64), (32, 32), (16, 32), (8, 64), (8, 32))


def k8_tiles() -> int:
    """``--k8-tiles``: hdiff's and fv_step's adjoint stencils at 512x512x80
    float32, periodic, built at each tile of ``K8_TILES``; each one's
    kernel timed by device time in the backward of the stencil's sum of
    squares, its gradient held to the default build's."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.models import full_dycore
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    fd = full_dycore.FullDycore(NI, NJ, NK, dtype=np.float32, backend="cuda", device=dev)
    state = fd.init_state(seed=0)
    cases = {"hdiff": (fd.dyn.hdiff, fd.dyn.hdiff_fn_p, ("in_field", "out_field"),
                       lambda u: {"in_field": u, "out_field": u, "coeff": state["coeff"]}),
             "fv_step": (fd.fv.fv_step, fd.fv.fns["step_p"], ("q",),
                         lambda q: {"q": q, "cx": state["cx"], "cy": state["cy"],
                                    "qout": torch.zeros_like(q)})}
    default = {n: c[0].backend.derivative("adjoint", c[2], NK, ("I", "J")) for n, c in
               cases.items()}
    builds = {}
    saved = cuda_backend.TILE_SHAPES
    try:
        for n, (st, _, wanted, _) in cases.items():
            d = default[n][0]
            for tile in K8_TILES:
                cuda_backend.TILE_SHAPES = (tile,)
                b = cuda_backend.CudaBackend(d.analysis, {})
                rec = b.program.plan_record()
                if rec["tiles"]:
                    builds[(n, tile)] = b
                else:
                    print(f"k8 tiles {n} {tile}: the tile form declines: "
                          f"{rec['declined'].get('tiles')}")
    finally:
        cuda_backend.TILE_SHAPES = saved
    t0 = time.perf_counter()
    n_src = build_all([b for _, b in default.values()] + list(builds.values())
                      + [c[0].backend for c in cases.values()])
    print(f"card: {smi}; build: {n_src} sources, {time.perf_counter() - t0:.2f} s")
    out = {}
    for (n, tile), b in builds.items():
        st, fn, wanted, args = cases[n]
        key = ("adjoint", tuple(wanted), NK, ("I", "J"))
        x0 = state["u"] if n == "hdiff" else state["q"]

        def grad():
            x = x0.clone().requires_grad_()
            o = next(iter(fn(**args(x)).values()))
            return torch.autograd.grad((o ** 2).sum(), x)[0]

        st.backend._derivatives[key] = (default[n][0], default[n][1])
        ref = grad()
        st.backend._derivatives[key] = (default[n][0], b)
        got = grad()
        err = _check_close(f"k8 tiles {n} {tile}", got, ref, GRAD_RTOL_F32,
                           GRAD_ATOL_F32 * float(ref.abs().max()))[0]
        _, rows = _device_ms(grad, n=10)
        ms = sum(v[0] for k, v in rows.items() if f"{b.analysis.stencil.name}_k" in k)
        (rec,) = b.program.plan_record()["tiles"]
        out[f"{n} {tile[0]}x{tile[1]}"] = {"device_ms": ms, "smem_bytes": rec["smem_bytes"],
                                           "ctas_per_sm": rec["ctas_per_sm"],
                                           "halo": rec["halo"], "max_abs_err": err,
                                           "ptxas": _ptxas(None, b.build_dir)}
        print(f"k8 tiles {n} adjoint {tile}: device {ms:.4f} ms; {rec['smem_bytes']} shared "
              f"bytes, {rec['ctas_per_sm']} CTAs a SM, halo {rec['halo']}; vs the default "
              f"build max abs {err:.3e}; {_ptxas(None, b.build_dir)}")
        st.backend._derivatives[key] = default[n]
    print(smi)
    print(json.dumps({"k8_tiles": out, "profile_losses": PROFILE_LOSSES, "card": smi},
                     default=str))
    return 1 if PROFILE_LOSSES else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import _build, cuda_backend
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, REPLACES
    from gt4py_tpu_torch.core import dtypes
    from gt4py_tpu_torch.core.definitions import BFLOAT16
    from gt4py_tpu_torch.models import dycore, full_dycore, fv_advection
    from gt4py_tpu_torch.next import benes, cuda_bridge
    from gt4py_tpu_torch.next.compiled_program import build_all
    from gt4py_tpu_torch.next.testing import bench_cases, program_fusion

    # -- 1. the card ------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  nvcc: {nvcc}")
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    # phase 14: the fuzzers' programs and the next-DSL kernels they lower to
    # (their CPU run records its own fallbacks, before phase 7's count starts)
    fuzz_builds = _fuzz_builds()
    fallback_cursor = cuda_bridge.FALLBACK_EVENTS.cursor()
    configs = {
        "f32": dict(shape=(NI, NJ, NK), dtype=np.float32, rtol=RTOL_F32, atol=ATOL_F32),
        "f64": dict(shape=SMALL, dtype=np.float64, rtol=RTOL_F64, atol=ATOL_F64),
    }
    models = {}
    for key, c in configs.items():
        models[key] = (
            full_dycore.FullDycore(*c["shape"], dtype=c["dtype"], backend="cuda", device=dev),
            full_dycore.FullDycore(*c["shape"], dtype=c["dtype"], backend="torch", device=dev),
        )
    registry = testing.load_stencil_defs()
    cases = {name: testing.registry_case(e) for name, e in registry.items()}
    cases.update(testing.SURFACE)
    surface = {name: cases[name] for names in SURFACE_FEATURES.values() for name in names}
    surface_stencils = {
        name: gtscript.stencil(backend="cuda", definition=d, rebuild=True,
                               externals=kw.get("externals", {}))
        for name, (d, _, kw) in surface.items()
    }
    main_stencils = [st for fd, _ in models.values()
                     for st in (fd.dyn.hdiff, fd.dyn.vadv_upd, fd.dyn.fused, fd.fv.fv_step, fd.sl)]
    # phase 8: MiniDycore and FvAdvection in bfloat16, kernels and plain
    bf16 = {backend: (dycore.MiniDycore(NI, NJ, NK, dtype=BFLOAT16, backend=backend, device=dev),
                      fv_advection.FvAdvection(NI, NJ, NK, dtype=BFLOAT16, backend=backend,
                                               device=dev))
            for backend in ("cuda", "torch")}
    bf16_stencils = [bf16["cuda"][0].hdiff, bf16["cuda"][0].vadv_upd, bf16["cuda"][1].fv_step]
    # phase 4: the fused step's split build; phase 10: the plane-sweep
    # stencils and the deep-K MiniDycore in both forms
    md_split = dycore.MiniDycore(NI, NJ, NK, dtype=np.float32, backend="cuda", device=dev,
                                 options={"serialize": False})
    # K5's path: the fused step in the sweep form
    md_sweep = dycore.MiniDycore(NI, NJ, NK, dtype=np.float32, backend="cuda", device=dev,
                                 options={"sweep": True})
    plane_defs = _plane_defs()
    deep = {label: dycore.MiniDycore(*DEEP, dtype=np.float32, backend=backend, device=dev,
                                     options=options)
            for label, backend, options in (("kblocked", "cuda", {"k_blocked": True}),
                                            ("one_pass", "cuda", {"k_blocked": False}),
                                            ("plain", "torch", {}))}
    deep512 = {"kblocked": dycore.MiniDycore(NI, NJ, NK, dtype=np.float32, backend="cuda",
                                             device=dev, options={"k_blocked": True}),
               "one_pass": models["f32"][0].dyn}
    fv_planes = fv_advection.make_fv_step(np.float32, "cuda", serialize=True)
    phase10_stencils = [md_split.fused, md_sweep.fused] + [
        p["cuda"] for p in plane_defs.values()] + [
        deep["kblocked"].hdiff, deep["kblocked"].vadv_upd, deep["one_pass"].vadv_upd,
        deep512["kblocked"].vadv_upd, fv_planes]
    # phase 11: the repair shapes, ShallowWater, the tight-halo steps, the
    # aligned stencils in the vector and the scalar form (one source each)
    p11 = _phase11_models(dev)
    # phase 12: the tile form and the fused column kernel against the
    # split builds, float32 at 512x512x80 and float64 at 64x256x16
    p12 = _phase12_builds(dev)
    # phase 4: the fused stencil's sweep, plane-sweep and split forms (K5);
    # phase 11: the tile kernels on tight buffers (K6); the K3 phase
    sweep_sts = _sweep_builds()
    tight = _tight_builds()
    k3_builds = _k3_builds()
    next_cases = {key: bench_cases(c["dtype"], c["shape"], dev) for key, c in configs.items()}
    next_kernels = [b for cases in next_cases.values() for case in cases.values()
                    for b in case["kernels"]()]
    t0 = time.perf_counter()
    n_sources = build_all(
        [st.backend for st in main_stencils + list(surface_stencils.values()) + bf16_stencils
         + phase10_stencils + _phase11_stencils(p11) + _phase12_stencils(p12)
            + [st for label, st in sweep_sts.items() if label != "plain"]
            + [st for st, _ in tight["builds"].values()] + _k3_stencils(k3_builds)]
        + next_kernels + fuzz_builds["backends"] + [benes.KERNEL] + _dist_builds()
        + _derivative_builds(models))
    build_s = time.perf_counter() - t0
    print(f"build: {n_sources} sources, {build_s:.2f} s (nvcc in parallel)")
    for st in main_stencils + phase10_stencils:
        print(f"built {st.name}: {len(st.backend.program.kernels)} kernels "
              f"{[k.form for k in st.backend.program.kernels]}, {_ptxas(st)}")
    print(f"built K9 (csrc/benes.cu, benes_pass): {_ptxas(None, benes.KERNEL.build_dir)}")

    # -- 3. kernel against plain (MiniDycore stencils) ----------------------
    errors = {}
    for key, (fd, fd_plain) in models.items():
        c = configs[key]
        md, md_plain = fd.dyn, fd_plain.dyn
        state = md.init_state(seed=3)
        diffused = md_plain.hdiff_fn_p(in_field=state["u"], out_field=state["u"],
                                       coeff=state["coeff"])["out_field"]
        calls = _stencil_calls(md, state, diffused)
        plain_calls = _stencil_calls(md_plain, state, diffused)
        for name, (st, call) in calls.items():
            before = st.backend.launches
            got = call()
            torch.cuda.synchronize()
            if st.backend.launches <= before:
                raise AssertionError(f"{st.name}: the kernels were not launched")
            ref = plain_calls[name][1]()
            worst = (0.0, 0.0)
            for field, t in got.items():
                e = _check_close(f"{st.name}.{field}", t, ref[field], c["rtol"], c["atol"])
                worst = (max(worst[0], e[0]), max(worst[1], e[1]))
            errors[(key, name)] = worst
            print(f"kernel vs plain {key} {st.name} {tuple(c['shape'])}: max abs "
                  f"{worst[0]:.3e}, max rel {worst[1]:.3e} (rtol {c['rtol']}, atol {c['atol']})")

    # -- 4. the MiniDycore path -------------------------------------------
    fd, fd_plain = models["f32"]
    md, md_plain = fd.dyn, fd_plain.dyn
    path = {"hdiff": md.hdiff, "vadv_update": md.vadv_upd, "dycore_fused": md.fused}
    state0 = md.init_state(seed=0)
    step, step_fused = md.step_fn(), md.step_fn(fused=True)
    for st in path.values():
        st.backend.launches = 0
    fused_before = md.fused.backend.device_launches()["all"]
    s_two, s_fused = state0, state0
    for _ in range(STEPS):
        s_two = step(s_two)
        s_fused = step_fused(s_fused)
    torch.cuda.synchronize()
    launches = {name: st.backend.launches for name, st in path.items()}
    fused_counted = md.fused.backend.device_launches()["all"] - fused_before
    print(f"MiniDycore path launches over {STEPS} steps of each form: {launches}; the fused "
          f"stencil's library counted {fused_counted} kernel launches")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"MiniDycore path never launched the {name} kernels")
    fused_plan = LAST_PLAN[md.fused.name]
    # the mixed-stencil default (cuda_backend.SERIALIZE_MIXED): the sweep
    # form, one kernel a call, or the split build, two
    want_forms, want_n = _mixed_default()
    if fused_plan["forms"] != want_forms or fused_counted != STEPS * want_n:
        raise AssertionError(f"the fused step ran {fused_plan['forms']} with {fused_counted} "
                             f"kernels counted, not {want_forms}, {want_n} a call: {fused_plan}")
    print(f"fused step plan: {fused_plan}")

    p_step, p_step_fused = md_plain.step_fn(), md_plain.step_fn(fused=True)
    r_two, r_fused = state0, state0
    for _ in range(STEPS):
        r_two = p_step(r_two)
        r_fused = p_step_fused(r_fused)
    shape = md.field_shape()
    for form, got, ref in (("step", s_two, r_two), ("fused step", s_fused, r_fused)):
        for field in ("u", "utens_stage"):
            if tuple(got[field].shape) != shape:
                raise AssertionError(f"{form} {field}: shape {tuple(got[field].shape)}")
            e = _check_close(f"{form} {field} after {STEPS} steps", got[field], ref[field],
                             RTOL_F32, ATOL_F32)
            print(f"MiniDycore {form} {field} after {STEPS} steps vs plain: max abs "
                  f"{e[0]:.3e}, max rel {e[1]:.3e}")
    _check_close("fused vs two-stencil step", s_fused["u"], s_two["u"], RTOL_F32, ATOL_F32)
    # K5: the default form against the split build and plain, bit for bit
    step_split = md_split.step_fn(fused=True)
    s_split = state0
    for _ in range(STEPS):
        s_split = step_split(s_split)
    torch.cuda.synchronize()
    if LAST_PLAN[md_split.fused.name]["forms"] != ["tile", "column"]:
        raise AssertionError("the split build of the fused step is not the tile form plus "
                             "the fused column kernel")
    for field in ("u", "utens_stage"):
        for label, ref in (("split build", s_split), ("plain", r_fused)):
            if not torch.equal(s_fused[field], ref[field]):
                raise AssertionError(f"fused {field}: the default form and the {label} "
                                     "differ after 10 steps")
    print(f"fused step: the default form {fused_plan['forms']}, the split build and plain "
          f"bitwise equal after {STEPS} steps (u, utens_stage)")
    # K5's path: 10 fused steps in the sweep form, its launches counted by
    # its library from 0 just before and read just after
    step_sweep = md_sweep.step_fn(fused=True)
    md_sweep.fused.backend.build()
    md_sweep.fused.backend.launches = 0
    sweep_before = md_sweep.fused.backend.device_launches()["all"]
    s_sweep = state0
    for _ in range(STEPS):
        s_sweep = step_sweep(s_sweep)
    torch.cuda.synchronize()
    sweep_counted = md_sweep.fused.backend.device_launches()["all"] - sweep_before
    sweep_plan = LAST_PLAN[md_sweep.fused.name]
    if sweep_plan["forms"] != ["sweep"] or sweep_counted != STEPS \
            or md_sweep.fused.backend.launches != STEPS:
        raise AssertionError(f"the fused step's sweep form: {sweep_counted} kernels counted "
                             f"over {STEPS} steps, plan {sweep_plan}")
    sweep_err = max(float((s_sweep[f] - r_fused[f]).abs().max()) for f in ("u", "utens_stage"))
    for field in ("u", "utens_stage"):
        for label, ref in (("default form", s_fused), ("plain", r_fused)):
            if not torch.equal(s_sweep[field], ref[field]):
                raise AssertionError(f"fused {field}: the sweep form and the {label} differ "
                                     f"after {STEPS} steps")
    print(f"fused step in the sweep form: {sweep_counted} kernel launches counted over {STEPS} "
          f"steps, bitwise equal to the default form and plain; sweep {sweep_plan['sweep']}")

    points = NI * NJ * NK
    step_ms = {
        "MiniDycore step cuda": _time_ms(lambda: step(state0), TIMING_REPS),
        "MiniDycore step plain": _time_ms(lambda: p_step(state0), PLAIN_TIMING_REPS),
        "MiniDycore fused step cuda": _time_ms(lambda: step_fused(state0), TIMING_REPS),
        "MiniDycore fused step plain": _time_ms(lambda: p_step_fused(state0), PLAIN_TIMING_REPS),
        "MiniDycore fused step split build": _time_ms(lambda: step_split(state0), TIMING_REPS),
        "MiniDycore fused step cuda (again)": _time_ms(lambda: step_fused(state0), TIMING_REPS),
        "MiniDycore fused step split build (again)": _time_ms(lambda: step_split(state0),
                                                              TIMING_REPS),
    }
    fused_b2b = {"default": _time_chain_ms(step_fused, state0, BACK_TO_BACK),
                 "split": _time_chain_ms(step_split, state0, BACK_TO_BACK)}
    print(f"MiniDycore fused step back to back ({BACK_TO_BACK} steps): default form "
          f"{fused_b2b['default']:.4f} ms, split build {fused_b2b['split']:.4f} ms")
    for k, ms in step_ms.items():
        print(f"{k}: {ms:.4f} ms per step, {points / ms / 1e6:.3f} Gpoint/s "
              f"(512x512x80 f32, median of CUDA-event times, one call at a time)")
    diffused = md_plain.hdiff_fn_p(in_field=state0["u"], out_field=state0["u"],
                                   coeff=state0["coeff"])["out_field"]
    calls = _stencil_calls(md, state0, diffused)
    plain_calls = _stencil_calls(md_plain, state0, diffused)
    kernels = []
    for name, (st, call) in calls.items():
        ms = _time_ms(call, TIMING_REPS)
        plain_ms = _time_ms(plain_calls[name][1], PLAIN_TIMING_REPS)
        bpp = sum(st.backend.program.bytes_per_point.values())
        print(f"{st.name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"~{bpp} bytes/point -> {bpp * points / ms / 1e6:.1f} GB/s")
        forms = {k.form for k in st.backend.program.kernels}
        kernels.append({
            "name": st.name,
            "route": "cuda",
            "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
            "replaces": "; ".join(REPLACES[f] for f in sorted(forms)) + "; " + REPLACES["wrap"],
            "launches": launches[name],
            "max_abs_err": errors[("f32", name)][0],
            "ms": ms,
            "plain_ms": plain_ms,
            **_bound(st.analysis, (NI, NJ, NK)),
        })

    # K5: the fused stencil in the sweep form, the plane-sweep form it
    # replaces and its split build, each timed and held to plain; the
    # pairs behind the mixed-stencil default; its plain counterpart (the
    # plain executor on the serialized stencil)
    fused_args = dict(u=state0["u"], coeff=state0["coeff"], wcon=state0["wcon"],
                      utens=state0["utens"], utens_stage=state0["utens_stage"],
                      u_out=state0["u"], dtr_stage=3.0)
    plain_ser = testing.plain_form(sweep_sts["sweep"]).functional(
        origin=(md.oi, md.oj, 0), domain=(NI, NJ, NK), physical_layout=True,
        periodic=("I", "J"))
    ser_out, ref_out = plain_ser(**fused_args), md_plain.fused_fn_p(**fused_args)
    if any(not torch.equal(ser_out[k], ref_out[k]) for k in ref_out):
        raise AssertionError("the serialized stencil's plain executor differs from plain")
    k5 = _sweep_pairs(sweep_sts)
    k5["plain_ms"] = _time_ms(lambda: plain_ser(**fused_args), PLAIN_TIMING_REPS)
    print(f"K5 dycore_fused_float32 {NI}x{NJ}x{NK}: sweep form {k5['sweep']['one_call_ms']:.4f} "
          f"ms one call at a time, {k5['sweep']['kernel_device_ms']:.4f} ms of device time; "
          f"plane-sweep form {k5['planes']['kernel_device_ms']:.4f}, split build "
          f"{k5['split']['kernel_device_ms']:.4f}; plain executor on the serialized stencil "
          f"{k5['plain_ms']:.4f} ms (bitwise equal to plain); SERIALIZE_MIXED = "
          f"{cuda_backend.SERIALIZE_MIXED}")
    kernels.append({
        "name": "K5 sweep form: dycore_fused_float32 serialized (one sweep kernel: the PARALLEL "
                "loop and the FORWARD and BACKWARD loops)",
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
        "replaces": REPLACES["sweep"],
        "launches": sweep_counted,
        "max_abs_err": sweep_err,
        "ms": k5["sweep"]["one_call_ms"],
        "plain_ms": k5["plain_ms"],
        **_bound(md.fused.analysis, (NI, NJ, NK)),
        "device_ms": k5["sweep"]["kernel_device_ms"],
        "planes_device_ms": k5["planes"]["kernel_device_ms"],
        "split_device_ms": k5["split"]["kernel_device_ms"],
        "b2b_pairs_ms": k5["b2b_pairs_ms"],
        "sweep_won": k5["sweep_won"],
        "step_b2b_ms": fused_b2b,
        "plan": fused_plan,
    })

    # -- 5. the language surface (float64), then the K3 phase ----------------
    k3 = {"cases": _k3(k3_builds, dev), "library": _k3_library(dev)}
    library = {"vark": k3["library"]["k3"], "data_dims": k3["library"]["k7"]}
    for feature, names in SURFACE_FEATURES.items():
        total, worst = 0, 0.0
        for name in names:
            d, make_inputs, kw = surface[name]
            got, ref, st = testing.run_pair(d, make_inputs, kw, dev)
            torch.cuda.synchronize()
            if st.backend.launches == 0:
                raise AssertionError(f"{name}: the kernels were not launched")
            total += st.backend.launches
            for field, t in ref.items():
                e = _check_close(f"{name}.{field}", got[field], t, RTOL_F64, ATOL_F64)
                worst = max(worst, e[0])
        d, make_inputs, kw = surface[SURFACE_TIMED[feature]]
        tensors, scalars = _scaled_inputs(make_inputs, (NI, NJ, NK), dev)
        timed = {}
        for backend in ("cuda", "torch"):
            st = gtscript.stencil(backend=backend, definition=d, rebuild=True,
                                  externals=kw.get("externals", {}))
            written = [k for k in tensors if st.field_info[k].access.value & 2]
            # the fields' own dtypes (bfloat16 inputs are drawn in float32)
            args = {k: dtypes.cast(v, st.field_info[k].dtype) for k, v in tensors.items()}

            # the call writes its outputs in place: each call gets fresh
            # copies of them, so every call does the same work
            def call(st=st, written=written, args=args, origin=kw.get("origin", (0, 0, 0))):
                st(**{k: (v.clone() if k in written else v) for k, v in args.items()},
                   **scalars, origin=origin)

            timed[backend] = _time_ms(call, TIMING_REPS if backend == "cuda"
                                      else PLAIN_TIMING_REPS)
            if backend == "cuda":
                # its kernels' device time a call, every launch in the profile
                _, rows = _device_ms(call, counted=[
                    (st.name, lambda st=st: st.backend.device_launches()["all"])])
                own = {k: v for k, v in rows.items() if st.name in k}
                device = (sum(ms for ms, _ in own.values()), sum(n for _, n in own.values()))
        dt = next(iter(args.values())).dtype
        print(f"surface {feature}: {len(names)} stencils, {total} launches, max abs err "
              f"{worst:.3e} (rtol {RTOL_F64}, atol {ATOL_F64}); "
              f"{SURFACE_TIMED[feature]} at 512x512x80 {dt}, J contiguous (outputs copied "
              f"per call): kernel {timed['cuda']:.4f} ms, plain {timed['torch']:.4f} ms; its "
              f"kernels {device[0]:.4f} ms of device time a call, {device[1]} launches a call")
        kernels.append({
            "name": f"{feature}: " + ", ".join(names),
            "route": "cuda",
            "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
            "replaces": REPLACES.get(feature, REPLACES["rows"] + "; " + REPLACES["columns"]),
            "launches": total,
            "max_abs_err": worst,
            "ms": timed["cuda"],
            "plain_ms": timed["torch"],
            **_bound(st.analysis, (NI, NJ, NK),
                     library[feature]["one_call_ms"] if feature in library else None),
            "device_ms": device[0],
            "device_launches_a_call": device[1],
        })
        if feature in library:
            kernels[-1]["library"] = library[feature]
        if feature == "vark":
            kernels[-1]["k3"] = {case: {k: r[k] for k in (
                "device_ms", "one_call_ms", "bound_ms", "launches_a_call", "outside_reads",
                "bitwise")} for case, r in k3["cases"].items()}

    # -- 6. the FullDycore path ---------------------------------------------
    fv_errors = {}
    for key, (fdc, fdp) in models.items():
        c = configs[key]
        state = fdc.init_state(seed=3)
        calls, plain_calls = _fv_calls(fdc, state), _fv_calls(fdp, state)
        for name, (st, call) in calls.items():
            before = st.backend.launches
            got = call()
            torch.cuda.synchronize()
            if st.backend.launches <= before:
                raise AssertionError(f"{st.name}: the kernels were not launched")
            ref = plain_calls[name][1]()
            e = _check_close(f"{st.name}.qout", got["qout"], ref["qout"], c["rtol"], c["atol"])
            fv_errors[(key, name)] = e
            print(f"kernel vs plain {key} {st.name} {tuple(c['shape'])}: max abs {e[0]:.3e}, "
                  f"max rel {e[1]:.3e} (rtol {c['rtol']}, atol {c['atol']})")
    prog = fd.fv.fv_step.backend.program
    an = fd.fv.fv_step.analysis
    scratch_bytes = 0
    for t in prog.scratch:
        ext = an.extents.alloc_extent(t)
        scratch_bytes += (NK - ext.k[0] + ext.k[1]) * (NI - ext.i[0] + ext.i[1]) * \
            (NJ - ext.j[0] + ext.j[1]) * np.dtype(an.stencil.temp_decls[t].dtype).itemsize
    print(f"fv_step f32: kernels {[k.form for k in prog.kernels]}, {len(prog.scratch)} scratch "
          f"temporaries ({scratch_bytes / 1e9:.3f} GB at 512x512x80), "
          f"{sum(len(k.planes.shared) for k in prog.kernels if k.planes)} in shared planes; "
          f"{_ptxas(fd.fv.fv_step)}")

    full_path = {"hdiff": fd.dyn.hdiff, "vadv_update": fd.dyn.vadv_upd,
                 "fv_step": fd.fv.fv_step, "sl_step": fd.sl}
    fstate0 = fd.init_state(seed=0)
    fstep, pfstep = fd.step_fn(), fd_plain.step_fn()
    for st in full_path.values():
        st.backend.launches = 0
    s = fstate0
    for _ in range(STEPS):
        s = fstep(s)
    torch.cuda.synchronize()
    full_launches = {name: st.backend.launches for name, st in full_path.items()}
    print(f"FullDycore path launches over {STEPS} steps: {full_launches}")
    for name, n in full_launches.items():
        if n == 0:
            raise AssertionError(f"FullDycore path never launched the {name} kernels")
    r = fstate0
    for _ in range(STEPS):
        r = pfstep(r)
    full_err = {}
    for field in ("u", "utens_stage", "q", "qsl"):
        if tuple(s[field].shape) != fd.field_shape():
            raise AssertionError(f"FullDycore {field}: shape {tuple(s[field].shape)}")
        full_err[field] = _check_close(f"FullDycore {field} after {STEPS} steps", s[field],
                                       r[field], RTOL_F32, ATOL_F32)
        print(f"FullDycore {field} after {STEPS} steps vs plain: max abs "
              f"{full_err[field][0]:.3e}, max rel {full_err[field][1]:.3e}")

    fv_step, pfv_step = fd.fv.step_fn(), fd_plain.fv.step_fn()
    fv_args = (fstate0["q"], fstate0["cx"], fstate0["cy"])
    t = {
        "fv cuda": _time_ms(lambda: fv_step(*fv_args), TIMING_REPS),
        "fv plain": _time_ms(lambda: pfv_step(*fv_args), PLAIN_TIMING_REPS),
        "dycore cuda": _time_ms(lambda: step(state0), TIMING_REPS),
        "dycore plain": _time_ms(lambda: p_step(state0), PLAIN_TIMING_REPS),
        "full cuda": _time_ms(lambda: fstep(fstate0), TIMING_REPS),
        "full plain": _time_ms(lambda: pfstep(fstate0), PLAIN_TIMING_REPS),
    }
    chain = {
        "fv cuda": _time_chain_ms(lambda q: fv_step(q, fv_args[1], fv_args[2]), fv_args[0],
                                  BACK_TO_BACK),
        "dycore cuda": _time_chain_ms(step, state0, BACK_TO_BACK),
        "full cuda": _time_chain_ms(fstep, fstate0, BACK_TO_BACK),
    }
    for k, ms in t.items():
        b2b = f"; back to back {chain[k]:.4f} ms ({points / chain[k] / 1e6:.3f} Gpoint/s)" \
            if k in chain else ""
        print(f"{k}: {ms:.4f} ms per step one call at a time ({points / ms / 1e6:.3f} "
              f"Gpoint/s){b2b}")
    for kind in ("cuda", "plain"):
        head = 2 * points / (t[f"dycore {kind}"] + t[f"fv {kind}"]) / 1e6
        line = f"headline {kind} (2 x points / (MiniDycore + FvAdvection step), one call at a " \
               f"time): {head:.3f} Gpoint/s"
        if kind == "cuda":
            head_b2b = 2 * points / (chain["dycore cuda"] + chain["fv cuda"]) / 1e6
            line += f"; back to back {head_b2b:.3f} Gpoint/s"
        print(line)
    for name, (st, call) in _fv_calls(fd, fstate0).items():
        ms = _time_ms(call, TIMING_REPS)
        plain_ms = _time_ms(_fv_calls(fd_plain, fstate0)[name][1], PLAIN_TIMING_REPS)
        bpp = sum(st.backend.program.bytes_per_point.values())
        print(f"{st.name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"~{bpp} bytes/point -> {bpp * points / ms / 1e6:.1f} GB/s")
        kernels.append({
            "name": st.name,
            "route": "cuda",
            "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
            "replaces": REPLACES["rows"] + "; " + REPLACES["wrap"],
            "launches": full_launches[name],
            "max_abs_err": fv_errors[("f32", name)][0],
            "ms": ms,
            "plain_ms": plain_ms,
            **_bound(st.analysis, (NI, NJ, NK)),
        })

    # -- 7. the next DSL ---------------------------------------------------
    next_errors = {}
    next_launches = {}
    next_bytes = {}
    for key, cases in next_cases.items():
        c = configs[key]
        for name, case in cases.items():
            kern = [k for obj in case["objs"] for k in cuda_bridge.kernels_of(obj)]
            for k in kern:
                k.launches = 0
            with program_fusion(case["fusion"]):
                got = case["run"]("cuda")
                torch.cuda.synchronize()
                counts = [k.launches for k in kern]
                ref = (cases["hdiff"] if name == "hdiff_kcontig" else case)["run"]("torch")
            if not kern or min(counts) == 0:
                raise AssertionError(f"next {name} {key}: a kernel was not launched "
                                     f"(launches {counts})")
            worst = 0.0
            for field, t in ref.items():
                e = _check_close(f"next {name} {key}.{field}", got[field], t, c["rtol"],
                                 c["atol"])
                worst = max(worst, e[0])
            next_errors[(key, name)] = worst
            next_launches[(key, name)] = sum(counts)
            # the bound of one call: that of the kernels it launches
            next_bytes[(key, name)] = sum(n * _min_bytes(k.analysis, c["shape"])
                                          for k, n in zip(kern, counts))
            print(f"next {name} {key} {tuple(c['shape'])}: {len(kern)} kernels "
                  f"({', '.join(sorted({k.analysis.stencil.name for k in kern}))}), launches "
                  f"{counts}, max abs err vs embedded torch {worst:.3e} "
                  f"(rtol {c['rtol']}, atol {c['atol']})")
    new_fallbacks = cuda_bridge.FALLBACK_EVENTS.since(fallback_cursor)
    if new_fallbacks:
        raise AssertionError(f"next operators ran embedded: {new_fallbacks}")
    print("next: cuda_bridge.FALLBACK_EVENTS unchanged across phases 2-7")
    for name, case in next_cases["f32"].items():
        with program_fusion(case["fusion"]):
            ms = _time_ms(lambda: case["run"]("cuda"), TIMING_REPS)
            b2b, host = _time_b2b_ms(lambda: case["run"]("cuda"), BACK_TO_BACK)
            plain_ms = _time_ms(lambda: case["run"]("torch"), PLAIN_TIMING_REPS) \
                if name != "hdiff_kcontig" else float("nan")
            plain_b2b, plain_host = _time_b2b_ms(lambda: case["run"]("torch"), BACK_TO_BACK) \
                if name != "hdiff_kcontig" else (float("nan"), float("nan"))
        print(f"next {name} 512x512x80 f32: kernels {ms:.4f} ms one call at a time, "
              f"{b2b:.4f} ms back to back ({BACK_TO_BACK} calls), host enqueue "
              f"{host:.4f} ms/call; embedded torch {plain_ms:.4f} ms one at a time, "
              f"{plain_b2b:.4f} ms back to back, host {plain_host:.4f} ms/call")
        if name == "hdiff_kcontig":
            continue
        kernels.append({
            "name": f"next {name}",
            "route": "cuda",
            "source": "gt4py_tpu_torch/next/cuda_bridge.py",
            "replaces": cuda_bridge.REPLACES,
            "launches": next_launches[("f32", name)],
            "max_abs_err": next_errors[("f32", name)],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": _bound_ms(next_bytes[("f32", name)]),
            "bound_by": "bytes",
            "library_ms": None,
        })

    # -- 8. the unstructured gather path (K9) and bfloat16 -----------------
    k9_raw = _k9_raw(dev)
    fvm = _fvm(dev)
    k9_entry = _k9_entry(dev, k9_raw, fvm)
    kernels.append(k9_entry)
    bf16_result = _bf16_steps(bf16)

    # -- 9. gradients (K8, and K9 in the backward) --------------------------
    gradients = _gradients(smi, models, fvm["cases"]["irregular"])
    kernels.append(gradients["entry"])
    k9_entry["backward"] = gradients["summary"]["routed"]

    # -- 10. plan modes: the plane-sweep form, K-blocked passes -------------
    planes = _plane_modes(plane_defs, dev)
    planes["fv_step_serialized"] = _fv_planes(fd, fv_planes)
    deep_k = _deep_k(deep, deep512, dev)
    kernels.append({
        "name": f"K4 K-blocked passes: vadv_upd_float32 at {DEEP[0]}x{DEEP[1]}x{DEEP[2]}",
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
        "replaces": REPLACES["kblocked"],
        "launches": deep_k["launches"]["kblocked"]["vadv_update"],
        "max_abs_err": max(deep_k["max_abs_err"].values()),
        "ms": deep_k["ms"]["kblocked"],
        "plain_ms": deep_k["plain_ms"],
        **_bound(deep_k.pop("analysis"), DEEP),
        "one_pass_ms": deep_k["ms"]["one_pass"],
        "b2b_pairs_ms": deep_k["b2b_pairs_ms"],
        "device_launches_per_call": deep_k["k4_device_launches"]
        / deep_k["launches"]["kblocked"]["vadv_update"],
        "launches_per_loop": deep_k["plan"]["kblocked"]["launches_per_loop"],
        "KB": deep_k["plan"]["kblocked"]["KB"],
        "slots": deep_k["plan"]["kblocked"]["slots"],
        "ctas_per_sm": deep_k["plan"]["kblocked"]["ctas_per_sm"],
        "ms_512x512x80": deep_k["at_512x512x80"]["ms"]["kblocked"],
    })

    # -- 11. K6: the vector row form and the repair -------------------------
    k6 = {"repair_shapes": _repair_shapes(p11["repair_defs"], dev),
          **_phase11(p11, tight, dev, kernels)}

    # -- 12. K1's tile form and K2's fused column kernel --------------------
    phase12 = _phase12(p12, fd, dev)
    for name, t in phase12["timings"].items():
        b = p12["f32"]["builds"][name]
        forms = (P12_FORMS[name] or _mixed_default())[0]
        label = " + ".join({"tile": "K1 tile form", "column": "K2 fused column"}[f]
                           for f in forms)
        kernels.append({
            "name": f"{label}: {b['tile'].name}",
            "route": "cuda",
            "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
            "replaces": "; ".join(REPLACES["rows" if f == "tile" else "columns"] for f in forms),
            "launches": phase12["launches"][name],
            "max_abs_err": phase12["max_abs_err"][name],
            "ms": min(t["ms"]),
            "plain_ms": t["plain_ms"],
            **t["bound"],
            "split_ms": min(t["split_ms"]),
            "b2b_pairs_ms": t["b2b_pairs_ms"],
            "device_ms": t["tile_device_ms"],
            "split_device_ms": t["split_device_ms"],
            "plan": {k: t["plan"][k] for k in ("forms", "tiles", "columns")},
        })

    # -- 13. the profiler's device events at the end of a long process -------
    profile_late = _profile_check(dev)

    # -- 14. the differential fuzzers ---------------------------------------
    fuzz = {**_fuzz(fuzz_builds, dev), "build_s": build_s}

    # -- 15. distribution: gloo ranks on the card ---------------------------
    distribution = _distribution(smi)

    # -- 16. the examples, each its own process ------------------------------
    examples = _examples(smi)

    print(smi)
    print(json.dumps({"kernels": kernels, "unstructured_fvm": fvm["summary"],
                      "bfloat16": bf16_result, "gradients": gradients["summary"],
                      "plan_modes": {"planes": planes, "deep_k": deep_k}, "k6": k6,
                      "phase12": {"full_dycore": phase12["full_dycore"],
                                  "checks": len(phase12["checks"])},
                      "profile_check": profile_late, "profile_losses": PROFILE_LOSSES,
                      "fuzz": fuzz, "distribution": distribution, "examples": examples},
                     default=str))
    if PROFILE_LOSSES:
        print(f"chip_smoke: {len(PROFILE_LOSSES)} profiles lost device events",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# --------------------------------------------------------------------------- #
# phase 14: the differential fuzzers
# --------------------------------------------------------------------------- #

#: phase 14: the share of points that may differ from the ORACLE in a
#: program with data-dependent branches (a condition within an ulp of its
#: threshold flips under the card's rounding); kernel against plain: none
FUZZ_FLIPS = 1e-4
#: phase 14's next-DSL and gather seeds
NEXT_FUZZ = {"operators": range(20), "programs": range(10), "bridge": range(20)}
GATHER_FUZZ = range(20)
#: the forms phase 14 must reach: kernel forms that launched
#: (``CudaBackend.launches_by_form``) and launches that staged rows or ran
#: in a periodic call (``_launches_with``)
FUZZ_COVERAGE = ("tile", "column", "vark", "kblocked", "staging_row_phase", "staging_element",
                 "periodic")
#: kernel form -> the TPU kernel it ports (PERF.md)
FUZZ_KERNELS = {"tile": "K1 tile", "rows": "K1 rows", "vector": "K1 vector rows (K6)",
                "column": "K2 fused column", "columns": "K2 column loop",
                "vark": "K3 staged variable K", "kblocked": "K4 K-blocked",
                "planes": "K5 plane-sweep", "sweep": "K5 sweep", "copy": "K5 snapshot copies"}
#: launches of a kind that ``_launches_with`` counts -> what it exercises
FUZZ_WITH = {"periodic": "K1a wrapped loads", "staging_row_phase": "K6 row-phase staging",
             "staging_element": "K6 element staging"}
#: phase 14's two forms that only fuzz programs reached, timed at a model's
#: size: form -> (leg, seed, domain); the seed's program (drawn as in its
#: leg) on the leg's layout, cuda against torch on the card
FUZZ_TIMED = {"per_level": ("wide", 6, (512, 512, 80)),
              "loop_group": ("base", 11, (512, 512, 80))}
#: phase 14's programs the kernels once declined -> the form that now runs
#: the CTA-iterated ``while`` (the plane-sweep kernel after a widened writer,
#: the tile kernel); each must launch it
FUZZ_REPAIRED = {("base", 147): "planes", ("base", 199): "tile", ("base", 386): "planes"}


def _next_fuzz_runs(device):
    """Every next-DSL fuzz case on ``device``: (kind, seed) -> NextCase."""
    from gt4py_tpu_torch.testing import next_fuzz

    runners = {"operators": next_fuzz.run_differential_case,
               "programs": next_fuzz.run_program_case, "bridge": next_fuzz.run_bridge_case}
    return {(kind, seed): runners[kind](seed, device=device)
            for kind, seeds in NEXT_FUZZ.items() for seed in seeds}


def _fuzz_builds() -> dict:
    """Phase 14's cartesian cases (``program_gen.LEGS``), each with its
    ``"cuda"`` build planned or declined, and the next legs run once on the
    CPU for the kernels the bridge lowers them to: the sources to build."""
    import warnings

    from gt4py_tpu_torch.testing import program_gen

    cases, declined = {}, {}
    for leg, (seeds, kw) in program_gen.LEGS.items():
        ckw = {k: v for k, v in kw.items() if k not in ("rtol", "atol")}
        for seed in seeds:
            case = program_gen.DifferentialCase(seed, **ckw)
            try:
                case.backend("cuda")
            except NotImplementedError as e:
                declined[(leg, seed)] = str(e)
            cases[(leg, seed)] = case
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        next_cpu = _next_fuzz_runs("cpu")
    return {"cases": cases, "declined": declined, "next_cpu_s": time.perf_counter() - t0,
            "backends": [c.backend("cuda") for key, c in cases.items() if key not in declined]
            + [k for c in next_cpu.values() for k in c.kernels]}


def _launches_with(case) -> dict:
    """Of one call's library-counted launches: those of its tile and sweep
    kernels where its plan records rows staged at a row phase or element
    by element (``staging_row_phase``, ``staging_element``), and all of
    them in a periodic call (``periodic``).  Not a partition: one launch
    may stage both ways."""
    out = {}
    staged = case.forms.get("tile", 0) + case.forms.get("sweep", 0)
    for s in set(case.plan.get("staging", {}).values()):
        out[f"staging_{s}"] = staged
    if case.periodic:
        out["periodic"] = case.launches
    return {k: v for k, v in out.items() if v}


def _fuzz_timed(fb: dict, dev) -> dict:
    """``FUZZ_TIMED``: each program at its model-size domain on ``"cuda"``
    and ``"torch"`` on the card, on the same inputs: held to each other at
    the float64 tolerances, the library's launches a call, and median
    CUDA-event ms of each."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN
    from gt4py_tpu_torch.cartesian.stencil_object import StencilObject
    from gt4py_tpu_torch.testing import program_gen

    out = {}
    for form, (leg, seed, domain) in FUZZ_TIMED.items():
        case = fb["cases"][(leg, seed)]
        be = case.backend("cuda")
        halo = case.origin[0]
        shape = (domain[0] + 2 * halo, domain[1] + 2 * halo, domain[2] + 2)
        rng = np.random.default_rng(seed)
        arrays = {n: rng.random(shape) for n in case.inputs}
        calls, fields = {}, {}
        for name in ("cuda", "torch"):
            b = case.backend(name)
            fields[name] = {n: program_gen._buffer(a, case.dtype, case.layout, dev)
                            for n, a in arrays.items()}
            obj = StencilObject(analysis=case.analysis, backend=b, backend_name=name,
                                name=case.analysis.stencil.name, options=case.options or {},
                                stencil_id=f"fuzz-timed-{seed}-{name}")
            calls[name] = (lambda obj=obj, f=fields[name]: obj(
                **f, **case.scalars, origin=case.origin, domain=domain, validate_args=False))
        before = be.device_launches()["all"]
        calls["cuda"]()
        torch.cuda.synchronize()
        launches = be.device_launches()["all"] - before
        calls["torch"]()
        for n in case.names:
            got, ref = fields["cuda"][n], fields["torch"][n]
            if not torch.allclose(got, ref, rtol=RTOL_F64, atol=ATOL_F64, equal_nan=True):
                diff = (got - ref).abs().nan_to_num().max()
                raise AssertionError(f"phase 14 {form} ({leg} seed {seed}) at {domain}: "
                                     f"'{n}' differs from plain by {float(diff)}")
        plan = LAST_PLAN[case.analysis.stencil.name]
        if form == "per_level" and "one launch a level" not in plan["declined"].get("ring", ""):
            raise AssertionError(f"phase 14 {form}: {leg} seed {seed} did not run a launch "
                                 f"a level at {domain}: {plan['declined']}")
        t = _in_turns({name: calls[name] for name in ("cuda", "torch")})
        out[form] = {"leg": leg, "seed": seed, "domain": list(domain), "launches": launches,
                     "forms": plan["forms"], "ms": t["cuda"], "plain_ms": t["torch"]}
        print(f"phase 14 timed {form} ({leg} seed {seed}, {domain}, {case.layout}, "
              f"{case.dtype}): {launches} launches a call, forms {plan['forms']}, cuda "
              f"{t['cuda']} ms, plain torch {t['torch']} ms (median CUDA-event ms, two turns)")
    return out


def _fuzz(fb: dict, dev) -> dict:
    """Phase 14: every program of ``program_gen.LEGS`` on ``"cuda"`` (its
    kernels, counted by its library by kernel: at least one launch a
    program, and their sum by form equal to the library's total) and on
    ``"torch"`` on the card, against the numpy oracle; the next-DSL
    operators, programs and bridge cases on ``"cuda"`` against embedded
    torch and the numpy oracle (the operators the bridge declines counted,
    the kernels' launches counted by their libraries); the gather and
    chain fuzz, routed (K9) against the index path, bit for bit (K9's
    launches counted by its library); the ``FUZZ_TIMED`` programs at a
    model's size.  Fails on any disagreement, on a program that launched
    no kernel, on a decline not in ``program_gen.LEG_DECLINES`` (or a
    pinned one that builds) and where the phase did not reach every form
    of ``FUZZ_COVERAGE``."""
    import warnings

    import numpy as np
    import torch

    from gt4py_tpu_torch.next import benes
    from gt4py_tpu_torch.testing import gather_fuzz, program_gen

    t0 = time.perf_counter()
    legs, launches, with_, reached, repaired = {}, {}, {}, set(), {}
    kernel_tol = {np.dtype(np.float64): (RTOL_F64, ATOL_F64)}
    for (leg, seed), case in fb["cases"].items():
        _, kw = program_gen.LEGS[leg]
        rtol, atol = kernel_tol.get(case.dtype, (RTOL_F32, ATOL_F32))
        program_gen.run_differential_case(
            seed, backends=("torch", "cuda"), device=dev, rtol=kw.get("rtol", 1e-12),
            atol=kw.get("atol", 1e-12), max_flip_fraction=FUZZ_FLIPS, kernel_rtol=rtol,
            kernel_atol=atol, count_kernels=True,
            allow_declines=(leg, seed) in program_gen.LEG_DECLINES, case=case)
        torch.cuda.synchronize()
        s = legs.setdefault(leg, {"programs": 0, "launches": 0, "forms": {}, "with": {},
                                  "declined": [], "rejected": 0, "kernel_vs_plain_max_abs": 0.0,
                                  "builds": {}, "builds_declined": []})
        s["programs"] += 1
        if case.declined is not None:
            s["declined"].append([seed, case.declined])
            continue
        if case.rejected:
            s["rejected"] += 1
            continue
        if "options" in kw:
            built = f"{case.options}, serialized {case.backend('cuda').program.serialized}"
            s["builds"][built] = s["builds"].get(built, 0) + 1
        s["launches"] += case.launches
        if (leg, seed) in FUZZ_REPAIRED:
            repaired[f"{leg} {seed}"] = {"launches": case.launches, "forms": dict(case.forms)}
            if not case.forms.get(FUZZ_REPAIRED[(leg, seed)]):
                raise AssertionError(f"phase 14: {leg} seed {seed} launched no "
                                     f"{FUZZ_REPAIRED[(leg, seed)]} kernel: {case.forms}")
        for f, n in case.forms.items():
            s["forms"][f] = s["forms"].get(f, 0) + n
            launches[f] = launches.get(f, 0) + n
            reached.add(f)
        for f, n in _launches_with(case).items():
            s["with"][f] = s["with"].get(f, 0) + n
            with_[f] = with_.get(f, 0) + n
            reached.add(f)
        for name in case.names:
            d = np.abs(case.results["cuda"][name] - case.results["torch"][name])
            s["kernel_vs_plain_max_abs"] = max(s["kernel_vs_plain_max_abs"],
                                               float(np.nanmax(d)) if d.size else 0.0)
        if case.declined_builds:
            s["builds_declined"].append([seed, case.options,
                                         [[o, why] for o, why in case.declined_builds],
                                         case.plan["declined"].get("sweep")])
    declined = {(leg, seed) for leg, s in legs.items() for seed, _ in s["declined"]}
    if declined != set(program_gen.LEG_DECLINES):
        raise AssertionError(f"phase 14: declined programs {sorted(declined)} are not the "
                             f"pinned ones {sorted(program_gen.LEG_DECLINES)}")
    for leg, s in legs.items():
        print(f"phase 14 {leg}: {s['programs']} programs, {s['launches']} kernel launches "
              f"(library), declined {s['declined']}, rejected {s['rejected']}, "
              f"kernel vs plain max abs {s['kernel_vs_plain_max_abs']:.3e}, launches by form "
              f"{dict(sorted(s['forms'].items()))}, of them {dict(sorted(s['with'].items()))}"
              + (f", builds {s['builds']}" if s["builds"] else ""))
        for seed, opts, why, sweep in s["builds_declined"]:
            print(f"phase 14 {leg} seed {seed}: built {opts}; declined {why}; "
                  f"LAST_PLAN declined sweep: {sweep}")
    print(f"phase 14: the programs once declined, launches by form (library): {repaired}")
    if "sweep" not in reached:
        print("phase 14: no program reached the sweep form (K5's sweep is held by phase 10)")
    cartesian_s = time.perf_counter() - t0

    # the next DSL: cuda against embedded torch and the numpy oracle
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        next_cases = _next_fuzz_runs(dev)
    torch.cuda.synchronize()
    nxt = {}
    for (kind, seed), c in next_cases.items():
        s = nxt.setdefault(kind, {"cases": 0, "fallbacks": 0, "launches": 0, "lowered": 0})
        s["cases"] += 1
        s["fallbacks"] += c.fallbacks
        s["launches"] += c.launches
        s["lowered"] += int(c.lowered)
    launches["next (K10)"] = sum(s["launches"] for s in nxt.values())
    for kind, s in nxt.items():
        print(f"phase 14 next {kind}: {s['cases']} cases, {s['lowered']} lowered to kernels, "
              f"{s['launches']} kernel launches (the stencil libraries' counts), "
              f"{s['fallbacks']} operators ran embedded (cuda_bridge.FALLBACK_EVENTS)")
    next_s = time.perf_counter() - t1

    # the gathers: routed (K9) against the index path, bit for bit
    t2 = time.perf_counter()
    gathers = {"outcomes": {}, "k9_permutes": 0}
    k9_before = benes.KERNEL.device_launches
    for seed in GATHER_FUZZ:
        for fn in (gather_fuzz.run_gather_case, gather_fuzz.run_chain_case):
            outcome, n = fn(seed, device=dev)
            if outcome == "routed" and n < 1:
                raise AssertionError(f"phase 14 gathers seed {seed}: routed without K9")
            gathers["outcomes"][outcome] = gathers["outcomes"].get(outcome, 0) + 1
            gathers["k9_permutes"] += n
    torch.cuda.synchronize()
    gathers["k9_launches"] = benes.KERNEL.device_launches - k9_before
    launches["K9 (gathers)"] = gathers["k9_launches"]
    print(f"phase 14 gathers: outcomes {gathers['outcomes']}, {gathers['k9_permutes']} permutes "
          f"ran K9 in {gathers['k9_launches']} kernel launches (its library's count)")
    gather_s = time.perf_counter() - t2

    missing = [f for f in FUZZ_COVERAGE if f not in reached]
    if missing:
        raise AssertionError(f"phase 14 reached no program in the forms {missing}")
    by_kernel = {FUZZ_KERNELS.get(f, f): n for f, n in sorted(launches.items())}
    launches_with = {FUZZ_WITH[f]: n for f, n in sorted(with_.items())}
    t3 = time.perf_counter()
    timed = _fuzz_timed(fb, dev)
    timed_s = time.perf_counter() - t3
    seconds = time.perf_counter() - t0
    print(f"phase 14: launches by kernel {by_kernel} (library counts); of the cartesian ones "
          f"{launches_with}; {seconds:.1f} s (cartesian {cartesian_s:.1f} s, next "
          f"{next_s:.1f} s, gathers {gather_s:.1f} s, timed forms {timed_s:.1f} s)")
    return {"seconds": seconds, "cartesian_s": cartesian_s, "next_s": next_s,
            "gather_s": gather_s, "timed_s": timed_s, "next_cpu_s": fb["next_cpu_s"],
            "legs": {leg: {k: v for k, v in s.items() if k != "builds_declined"}
                     for leg, s in legs.items()},
            "next": nxt, "gathers": gathers, "launches_by_kernel": by_kernel,
            "launches_with": launches_with, "timed": timed, "repaired": repaired,
            "declined": sorted(map(list, declined))}


def fuzz_only() -> int:
    """``--fuzz``: phase 14 alone (its builds, the legs)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.next import benes
    from gt4py_tpu_torch.next.compiled_program import build_all

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"card: {smi}")
    fb = _fuzz_builds()
    t0 = time.perf_counter()
    n = build_all(fb["backends"] + [benes.KERNEL])
    build_s = time.perf_counter() - t0
    print(f"build: {n} sources, {build_s:.2f} s (nvcc in parallel)")
    result = _fuzz(fb, dev)
    print(smi)
    print(json.dumps({"fuzz": {**result, "build_s": build_s, "sources": n}}, default=str))
    return 0


# --------------------------------------------------------------------------- #
# phase 15: distribution
# --------------------------------------------------------------------------- #

#: phase 15: gloo ranks on the one card as a 2x2 mesh, the bench size (K, I, J)
DIST_RANKS, DIST_MESH, DIST_SHAPE, DIST_STEPS = 4, (2, 2), (NK, NI, NJ), 3


def _dist_builds():
    """The stencils the ranks run (MiniDycore's hdiff and vadv_update,
    fv_step, float32; the global view's generated programs), built here
    first so the ranks load them."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.models import dycore, fv_advection
    from gt4py_tpu_torch.parallel.distributed import _plan_of
    from gt4py_tpu_torch.testing import dist_cases

    dev = torch.device("cuda", 0)
    md = dycore.MiniDycore(8, 8, 4, dtype=np.float32, backend="cuda", aligned=False, device=dev)
    fv = fv_advection.FvAdvection(8, 8, 4, dtype=np.float32, backend="cuda", aligned=False,
                                  device=dev)
    # the phased calls: the whole stencils (the single-device runs) and
    # the stencils of their phases
    phased = [dist_cases._ring_stencil("cuda")] + [
        dist_cases.gspmd_stencil(sd, "cuda")[0] for sd in dist_cases.PHASED_SEEDS]
    return [md.hdiff.backend, md.vadv_upd.backend, fv.fv_step.backend] + [
        dist_cases.gspmd_stencil(sd, "cuda")[0].backend for sd in dist_cases.GSPMD_SEEDS] + [
        st.backend for st in phased] + [o.backend for st in phased for o in _plan_of(st).onces]


def _distribution(smi: str) -> dict:
    """Phase 15: ``testing.dist_cases.chip_distribution`` on ``DIST_RANKS``
    gloo ranks sharing the card (strips staged through host memory), each
    rank's failure failing the phase; the checks on rank 0's comparisons."""
    import tempfile

    import torch

    from gt4py_tpu_torch.testing import dist_cases

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_dist_") as work:
        both = dist_cases.launch(
            {"p15": dict(case="chip_distribution", shape=DIST_SHAPE, steps=DIST_STEPS),
             "phased": dict(case="chip_phased")},
            workdir=work, ranks=DIST_RANKS, shape=DIST_MESH, device="cuda", strict=True,
            timeout=600)
    wall_s = time.perf_counter() - t0
    res = both["p15"]
    out = res[0][1]
    phased = _phased(both["phased"][0][1], smi)
    ranks = out.pop("ranks")
    for r in ranks:
        for name in ("hdiff", "vadv_update"):
            if r["launches"][name] < DIST_STEPS or r["overlap_launches"][name] < 5 * DIST_STEPS:
                raise RuntimeError(f"phase 15: rank {r['rank']} launched {name} "
                                   f"{r['launches'][name]} times ({r['overlap_launches'][name]} "
                                   "overlapped): a rank ran plain")
        if r["fv_launches"] < 1 or r["device"] != f"cuda:{r['rank'] % torch.cuda.device_count()}":
            raise RuntimeError(f"phase 15: rank {r['rank']}: fv_step launches {r['fv_launches']}"
                               f", device {r['device']}")
        for key in ("exchange", "wire_exchange"):
            ex = r[key]
            if ex["backend"] != "gloo" or not ex["staged"]:
                raise RuntimeError(f"phase 15: rank {r['rank']}'s {key} ran {ex}, not gloo "
                                   "staged through host memory")
        if r["wire_exchange"]["bytes"] * 2 != r["exchange"]["bytes"] or \
                r["wire_bytes"]["bfloat16"] * 2 != r["wire_bytes"]["float32"] or \
                r["exchange"]["bytes"] != r["wire_bytes"]["float32"]:
            raise RuntimeError(f"phase 15: the bfloat16 wire's bytes {r['wire_exchange']}")
        if not r["wire_blocks_equal"] or r["wire_strips_moved"] == 0:
            raise RuntimeError(f"phase 15: rank {r['rank']}'s bfloat16 wire's blocks differ by "
                               f"{r['wire_blocks_max_abs']} from the float32 exchange's with "
                               f"each strip cast to bfloat16 and back (the strips moved by "
                               f"{r['wire_strips_moved']})")
        if r["overlap_vs_plain"] > 0:
            raise RuntimeError(f"phase 15: rank {r['rank']}'s overlapped step differs from the "
                               f"plain one by {r['overlap_vs_plain']}")
        if not all(n >= 1 for n in r["gspmd_launches"].values()):
            raise RuntimeError(f"phase 15: rank {r['rank']} ran a global-view program on no "
                               f"kernel: {r['gspmd_launches']}")
    if not (all(out["close"].values()) and out["fv_close"] and out["finite"]):
        raise RuntimeError(f"phase 15: the sharded steps disagree with the single-device "
                           f"steps: {out}")
    if out["fv_mass_rel"] > 1e-4:
        raise RuntimeError(f"phase 15: tracer mass: {out}")
    if max(out["gspmd_max_abs_err"].values()) > ATOL_F64:
        raise RuntimeError(f"phase 15: the global view's programs against plain: "
                           f"{out['gspmd_max_abs_err']}")
    print(f"phase 15 ({smi}): {DIST_RANKS} gloo ranks, {DIST_MESH[0]}x{DIST_MESH[1]} mesh, "
          f"{DIST_SHAPE} float32, {wall_s:.1f} s; max |sharded - single| "
          f"u {out['max_abs_err']['u']:.3e} utens_stage {out['max_abs_err']['utens_stage']:.3e}"
          f" (bitwise {out['equal']}), fv {out['fv_max_abs_err']:.3e}, mass "
          f"{out['fv_mass_rel']:.2e}, bf16 wire max |d| {out['wire_max_abs_vs_float32']:.3e} "
          f"after a step, its blocks bit for bit the float32 exchange's cast to bfloat16 and "
          f"back on every rank (strips moved up to "
          f"{max(r['wire_strips_moved'] for r in ranks):.3e}); "
          f"global view on the kernels (float64, regions in the global frame), max |kernels - "
          f"single-device plain| {out['gspmd_max_abs_err']}, rank 0's launches "
          f"{ranks[0]['gspmd_launches']}")
    for r in ranks:
        print(f"phase 15 ({smi}): rank {r['rank']} step {r['step_ms']:.3f} ms, overlapped "
              f"{r['overlap_step_ms']:.3f} ms, exchange {r['exchange_ms']:.3f} ms "
              f"({r['exchange']['bytes']} B; bfloat16 wire {r['wire_exchange_ms']:.3f} ms), "
              f"kernels {r['kernel_ms']}, FvAdvection step {r['fv_sharded_step_ms']:.3f} ms, "
              f"launches {r['launches']}")
    return {"card": smi, "wall_s": wall_s, "ranks": ranks, **out, "phased": phased}


def _phased(res: dict, smi: str) -> dict:
    """Phase 15's phased calls (``dist_cases.chip_phased``): every rank's
    calls launched the kernels of every phase (the libraries' counts) and
    ran in phases; rank 0's gathered results equal the single-device
    ``"cuda"`` runs bit for bit.  Prints each call's exchanges and times."""
    from gt4py_tpu_torch.testing import dist_cases

    ranks = res["ranks"]
    for r in ranks:
        for name, rec in r.items():
            if name == "rank":
                continue
            if not rec["phased"] or rec["library_launches"] <= 0 or \
                    not all(n > 0 for n in rec["phase_launches"]):
                raise RuntimeError(f"phase 15: rank {r['rank']}'s phased call {name} ran "
                                   f"{rec}: a phase launched no kernel")
    for name, single in res["single"].items():
        if not (single["equal"] and single["finite"]):
            raise RuntimeError(f"phase 15: the phased call {name} differs from the "
                               f"single-device run by {single['max_abs_err']}")
    r0 = ranks[0]
    for name, single in res["single"].items():
        rec = r0[name]
        shape = dist_cases.PHASED_RING_SHAPE if name == "ring" else "generated"
        times = ", ".join("rank %d %.3f ms" % (r["rank"], r[name]["ms"]) for r in ranks)
        print(f"phase 15 ({smi}): phased {name} ({shape}, float64, {DIST_RANKS} gloo ranks) "
              f"bit for bit the single-device run: {rec['phases']} phase stencils, "
              f"{rec['runs']} runs ({rec['levels']} levels, iterations {rec['iterations']}), "
              f"{rec['exchanges']} exchanges ({rec['bytes']} B from rank 0), rank 0's "
              f"launches {rec['library_launches']} {rec['forms']}; {times} a call "
              f"(CUDA events, median of 5) against {single['single_ms']:.3f} ms single-device; "
              f"rank 0's phase kernels {rec['kernel_ms']} ms a call")
    return {"ranks": ranks, "single": res["single"]}


# --------------------------------------------------------------------------- #
# phase 16: the examples
# --------------------------------------------------------------------------- #

#: ``--examples`` and phase 16: each example's command's limit, seconds
EXAMPLE_LIMIT_S = 600


def _examples(smi: str) -> dict:
    """Phase 16: every example of ``gt4py_tpu_torch.examples`` run as its
    command (``python -m gt4py_tpu_torch.examples.<name>``, on the card by
    default), all started together, each in its own process; each must
    exit 0 on the card and launch kernels: the CUDA kernels
    ``torch.profiler`` saw (``GT4PY_TPU_TORCH_EXAMPLE_KERNELS=1``), and
    for the examples with a ``"cuda"`` path the stencil libraries' and
    K9's counted launches.  Prints each one's seconds."""
    from gt4py_tpu_torch.examples import EXAMPLES

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "GT4PY_TPU_TORCH_EXAMPLE_KERNELS": "1"}
    import tempfile
    import threading

    procs, ended = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_examples_") as logs:
        for name in EXAMPLES:
            files = [open(os.path.join(logs, f"{name}.{x}"), "w+") for x in ("out", "err")]
            p = subprocess.Popen([sys.executable, "-m", f"gt4py_tpu_torch.examples.{name}"],
                                 cwd=root, env=env, stdout=files[0], stderr=files[1], text=True)
            procs[name] = (p, files, time.perf_counter())

            def wait(name=name, p=p):  # each one's own end
                try:
                    p.wait(timeout=EXAMPLE_LIMIT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                ended[name] = time.perf_counter()

            threading.Thread(target=wait, daemon=True).start()
        for p, _, _ in procs.values():
            p.wait()
        while len(ended) < len(procs):
            time.sleep(0.01)
        texts = {}
        for name, (p, files, _) in procs.items():
            for f in files:
                f.seek(0)
            texts[name] = [f.read() for f in files]
            for f in files:
                f.close()
    out = {}
    for name, (p, _, t0) in procs.items():
        stdout, stderr = texts[name]
        seconds = ended[name] - t0
        if p.returncode != 0:
            raise RuntimeError(f"phase 16: example {name} exited {p.returncode} after "
                               f"{seconds:.1f} s:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        got = json.loads(stdout.strip().splitlines()[-1])
        if not got["device"].startswith("cuda") or not got["device_kernels"] or (
                name in EXAMPLES_WITH_KERNELS and got["launches"] <= 0):
            raise RuntimeError(f"phase 16: example {name} launched no kernel on the card: "
                               f"{got}")
        out[name] = {"seconds": seconds, "launches": got["launches"],
                     "device_kernels": got["device_kernels"], "device": got["device"]}
    print(f"phase 16 ({smi}): the examples on the card, each its own process, all at once: "
          + ", ".join(f"{n} {r['seconds']:.1f} s ({r['device_kernels']} CUDA kernels, "
                      f"{r['launches']} counted by the libraries)" for n, r in out.items()))
    return out


#: the examples with a ``"cuda"`` path (the JAX ones' ``"pallas"``)
EXAMPLES_WITH_KERNELS = ("cartesian_tutorial", "next_quickstart")


def examples_only() -> int:
    """``--examples``: phase 16 alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = _nvidia_smi()
    print(f"card: {smi}")
    result = _examples(smi)
    print(smi)
    print(json.dumps({"examples": result}, default=str))
    return 0


def dist_only() -> int:
    """``--dist``: phase 15 alone (its builds, the ranks)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.next.compiled_program import build_all

    smi = _nvidia_smi()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    n = build_all(_dist_builds())
    print(f"build: {n} sources, {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    result = _distribution(smi)
    print(smi)
    print(json.dumps({"distribution": result}, default=str))
    return 0


def k9_layouts() -> int:
    """``--k9-layouts``: K9's device time per permute (``torch.profiler``)
    in each layout and register count, bitwise checked; one JSON line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gt4py_tpu_torch.next import benes

    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    out = {}
    for P in K9_LAYOUT_SIZES:
        sigma, _ = _perm(P, 11)
        words = torch.from_numpy(np.random.default_rng(12).random(P).astype(np.float32)) \
            .to(dev).view(torch.int32)
        ref = words[torch.from_numpy(sigma).to(dev)]
        k = max(1, int(P - 1).bit_length())
        ctrl = benes.route(np.concatenate([sigma, np.arange(P, 1 << k)]))
        saved = benes._REG_LOG2
        for b, c in K9_LAYOUTS:
            for e in K9_REG_LOG2:
                benes._REG_LOG2 = e  # the plan's programs keep what it was built with
                try:
                    plan = benes.Plan(P, k, ctrl, b, c)
                finally:
                    benes._REG_LOG2 = saved
                if not torch.equal(benes.KERNEL.launch(words, plan), ref):
                    raise AssertionError(f"K9 P={P} b={b} c={c} e={e}: kernel != x[sigma]")
                out[f"P{P}_b{b}_c{c}_e{e}"] = _device_ms(
                    lambda: benes.KERNEL.launch(words, plan))[0]
    print(f"card: {smi}")
    print("K9 device ms per permute by layout: " + ", ".join(
        f"{key} {'not measured' if v is None else f'{v:.4f}'}" for key, v in out.items()))
    print(json.dumps({"k9_layouts_device_ms": out, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(k9_layouts() if sys.argv[1:] == ["--k9-layouts"] else
             fuzz_only() if sys.argv[1:] == ["--fuzz"] else
             dist_only() if sys.argv[1:] == ["--dist"] else
             examples_only() if sys.argv[1:] == ["--examples"] else
             k3_only() if sys.argv[1:] == ["--k3"] else
             k8_only() if sys.argv[1:] == ["--k8"] else
             k8_tiles() if sys.argv[1:] == ["--k8-tiles"] else
             k3_tiles() if sys.argv[1:] == ["--k3-tiles"] else
             tiles_only() if sys.argv[1:] == ["--tiles"] else
             profile_check() if sys.argv[1:] == ["--profile-check"] else
             tile_sweep() if sys.argv[1:] == ["--tile-sweep"] else
             k6_k5() if sys.argv[1:] == ["--k6-k5"] else
             k6_k5(tight_only=True) if sys.argv[1:] == ["--k6-k5", "tight"] else main())
