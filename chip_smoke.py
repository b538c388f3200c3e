#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: the FullDycore step on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (a failed phase raises, and the script exits non-zero):

1. require a CUDA device; print the torch, CUDA and nvcc versions and the
   card's name and power limit;
2. build every generated CUDA kernel the later phases launch from the
   repository's sources (one nvcc per stencil, all started together,
   sm_90a) and print the build seconds and ptxas' report;
3. kernel against plain on the card: ``backend="cuda"`` against
   ``backend="torch"`` for hdiff, vadv_update and dycore_fused, periodic,
   at 512x512x80 float32 and 64x256x16 float64;
4. the MiniDycore path: ``MiniDycore(512, 512, 80, float32, backend="cuda")``,
   10 steps of ``step_fn()`` and of ``step_fn(fused=True)``, with the launch
   counts of every kernel read around that run, the state checked finite
   and against the plain executor, and both forms timed with CUDA events;
5. the language surface: every canonical stencil with ``while``, regions,
   variable K or data dimensions (``tests/cartesian/stencil_defs.py``) and
   the ``.at(K=...)`` forms (``gt4py_tpu_torch.testing.SURFACE``), in
   float64, each launched once with its count read around that run and its
   result held against the plain executor; one stencil per feature timed
   at 512x512x80;
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
   ``csrc/benes.cu``) on raw permutations (P = 2^17, 2^17 + 311, 2^20 in
   float32, 2^17 in int32 with NaN-aliasing patterns) against its plain
   version and ``x[sigma]``, bit for bit; bench.py's unstructured FVM step
   at n = 512 float32 on ``grid_mesh`` (affine windows) and
   ``shuffled_mesh(512, 7)`` (sort-routed, K9), 10 steps with the
   planners on against 10 on the index path (``config.AFFINE_GATHER =
   config.SORT_GATHER = False``), bit for bit, with K9's launches read
   around the irregular run; CUDA-event times of the step (one call at a
   time, 20 back to back, the host's enqueue time), of K9 per permute
   against ``torch.index_select`` of the same permutation and its bound,
   and a ``torch.profiler`` breakdown of the irregular step; then one
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
   the index path.

Every kernel entry carries ``bound_ms``: the least time the card could take
for the same function, its bytes (each input read once, each output written
once) over 3.35 TB/s, the H100 SXM's memory rate (the stencils and K9 do a
few operations per byte, so bytes bound them), and ``library_ms``, the time
of one PyTorch call that computes the same function where there is one
(none for the stencils; ``torch.index_select`` for K9).  K8's entry is the
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

STEPS = 10
TIMING_REPS = 20
#: the H100 SXM's device-memory rate (bytes per second), for ``bound_ms``
HBM_BYTES_PER_S = 3.35e12
#: phase 8: bench.py's unstructured FVM size and K9's raw permutations
FVM_N = 512
K9_RAW = [(1 << 17, "float32"), ((1 << 17) + 311, "float32"), (1 << 20, "float32"),
          (1 << 17, "int32")]
#: the JAX package's chip test's NaN/Inf/sign bit patterns (int32 leg)
NAN_PATTERNS = [0x7F800001, 0x7FC00000, 0x7F800000, 0xFF800000, 0x80000000, 0xFFFFFFFF]
PLAIN_TIMING_REPS = 3
BACK_TO_BACK = 20
NI, NJ, NK = 512, 512, 80
SMALL = (64, 256, 16)

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


def _ptxas(st) -> str:
    log = open(os.path.join(st.backend.build_dir, "build.log")).read()
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


def _bound(analysis, shape) -> dict:
    """The ``bound_ms``/``bound_by``/``library_ms`` keys of a stencil."""
    return {"bound_ms": _bound_ms(_min_bytes(analysis, shape)), "bound_by": "bytes",
            "library_ms": None}


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
    y out, the control bits read once); ``model``, what this design moves
    (the padded copy in and out, the inner pass over every word, 8 bytes
    per element for each outer stage, every bit-plane once)."""
    bits = plan.bits.nbytes
    outer = 2 * (plan.k - plan.b)
    return {"function": 8 * plan.P + bits,
            "model": 8 * plan.P + 8 * plan.n2 + 8 * plan.n2 * outer + bits}


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
        before = benes.KERNEL.launches
        got = benes.permute(x, keys)
        torch.cuda.synchronize()
        launched = benes.KERNEL.launches - before
        if launched <= 0:
            raise AssertionError(f"K9 P={P} {dt}: the kernel was not launched")
        sig = torch.from_numpy(sigma).to(dev)
        ref = x[sig]
        plan = benes._plan(keys)
        plain = torch.zeros(plan.n2, dtype=torch.int32, device=dev)
        plain[:P] = x.view(torch.int32)
        benes.plain_inplace(plain, plan)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K9 P={P} {dt}: kernel != x[sigma]")
        if not torch.equal(got.view(torch.int32), plain[:P]):
            raise AssertionError(f"K9 P={P} {dt}: kernel != its plain version")
        # int32 words were compared bit for bit above
        err = float((got - ref).abs().max()) if dt == "float32" else 0.0
        print(f"K9 P={P} {dt}: launches {launched}, bitwise equal to x[sigma] and to the "
              f"plain butterfly (n2 = 2^{plan.k}, block 2^{plan.b}, "
              f"{2 * (plan.k - plan.b)} outer stages), max abs err {err:.3e}")
        out.append({"P": P, "dtype": dt, "launches": launched, "max_abs_err": err})
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
        psi = psi0
        for _ in range(STEPS):
            psi = step(psi)
        torch.cuda.synchronize()
        k9 = benes.KERNEL.launches
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
              f"{k9}; {STEPS} steps bitwise equal to the index path; set-up {setup_s:.2f} s")
        print(f"FVM {label}: {ms:.4f} ms per step one call at a time ({medges:.1f} Medges/s), "
              f"{b2b:.4f} ms back to back ({BACK_TO_BACK} calls, "
              f"{mesh.n_edges / b2b / 1e3:.1f} Medges/s), host enqueue {host:.4f} ms/step; "
              f"index path {index_ms:.4f} ms one at a time, {index_b2b:.4f} ms back to back, "
              f"host {index_host:.4f} ms/step")
        summary[label] = {"ms": ms, "b2b_ms": b2b, "host_ms": host, "medges_s": medges,
                          "index_ms": index_ms, "index_b2b_ms": index_b2b,
                          "index_host_ms": index_host, "k9_launches": k9,
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, psi = case["step"], case["psi0"]
    step(psi)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            psi = step(psi)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device events only: a CPU op's device time repeats its kernels'
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 5, e.count / 5))
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
    ``torch.index_select`` of the same permutation, and its bound."""
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
        buf = torch.zeros(plan.n2, dtype=torch.int32, device=dev)
        plain_ms = _time_ms(lambda: benes.plain_inplace(buf, plan), PLAIN_TIMING_REPS)
        lib_ms = _time_ms(lambda: torch.index_select(x, 0, sig), TIMING_REPS)
        nbytes = _k9_bytes(plan)
        per_shape[name] = {"P": P, "n2": plan.n2, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": _bound_ms(nbytes["function"]),
                           "model_ms": _bound_ms(nbytes["model"])}
        print(f"K9 {name} P={P} (n2 2^{plan.k}): kernel {ms:.4f} ms per permute, plain "
              f"{plain_ms:.4f} ms, torch.index_select {lib_ms:.4f} ms; bound "
              f"{per_shape[name]['bound_ms']:.4f} ms ({nbytes['function']} B), this design's "
              f"traffic {per_shape[name]['model_ms']:.4f} ms ({nbytes['model']} B) at 3.35 TB/s")
    v = per_shape["v2e"]
    return {
        "name": "benes_permute (K9)",
        "route": "cuda",
        "source": "gt4py_tpu_torch/csrc/benes.cu",
        "replaces": "gt4py_tpu/next/benes.py:253 permute (_inner_kernel :213, pallas_call "
                    ":308; outer stages _xla_stage :204)",
        "launches": fvm["summary"]["irregular"]["k9_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in raw),
        "ms": v["ms"],
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


def _gradients(smi, models, fvm_case) -> dict:
    """Phase 9: the FullDycore step's gradient at 512x512x80 float32 with
    the forward on the kernels, against the plain executor's on the card;
    its times and peak memory; ``torch.func.jvp`` of the MiniDycore step;
    central differences at 64x256x16 float64; the routed FVM energy's
    gradient (K9 in both directions)."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import REPLACES

    fd, fd_plain = models["f32"]
    step, pstep = fd.step_fn(), fd_plain.step_fn()
    state = fd.init_state(seed=0)
    path = {"hdiff": fd.dyn.hdiff, "vadv_update": fd.dyn.vadv_upd, "fv_step": fd.fv.fv_step,
            "sl_step": fd.sl}
    for st in path.values():
        st.backend.launches = st.backend.derivative_calls = 0
    grads = _full_grad(step, state)
    torch.cuda.synchronize()
    counts = {n: (st.backend.launches, st.backend.derivative_calls) for n, st in path.items()}
    print(f"FullDycore gradient path (launches, under K8): {counts}")
    if min(n for n, _ in counts.values()) == 0:
        raise AssertionError(f"FullDycore gradient: a forward kernel was not launched ({counts})")
    if min(counts[n][1] for n in ("hdiff", "vadv_update", "fv_step")) == 0:
        raise AssertionError(f"FullDycore gradient: K8 did not engage ({counts})")
    ref = _full_grad(pstep, state)
    errs, bitwise = {}, {}
    for name, g, r in zip(("u", "q"), grads, ref):
        errs[name] = _check_close(f"FullDycore gradient d/d{name} vs plain", g, r, RTOL_F32,
                                  ATOL_F32)[0]
        bitwise[name] = torch.equal(g, r)
        if not float(g.abs().max()) > 0:
            raise AssertionError(f"FullDycore gradient d/d{name} is zero")
    print(f"FullDycore 512x512x80 f32 gradient vs the plain executor's: max abs {errs} "
          f"(rtol {RTOL_F32}, atol {ATOL_F32}), bitwise {bitwise}")

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
         "cuda fwd+bwd": _time_ms(fwd_bwd(step), PLAIN_TIMING_REPS),
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

    # torch.func.jvp of the MiniDycore step
    md, md_plain = fd.dyn, fd_plain.dyn
    s0 = md.init_state(seed=0)
    tangent = torch.from_numpy(np.random.default_rng(5).random(tuple(s0["u"].shape)).astype(
        np.float32)).to(s0["u"].device)
    for st in (md.hdiff, md.vadv_upd):
        st.backend.launches = st.backend.derivative_calls = 0
    _, tang = torch.func.jvp(lambda u: md.step_fn()({**s0, "u": u})["u"], (s0["u"],), (tangent,))
    torch.cuda.synchronize()
    jvp_counts = [(st.backend.launches, st.backend.derivative_calls)
                  for st in (md.hdiff, md.vadv_upd)]
    if jvp_counts != [(1, 1), (1, 1)]:
        raise AssertionError(f"MiniDycore jvp: kernels (launches, under K8) {jvp_counts}")
    _, rtang = torch.func.jvp(lambda u: md_plain.step_fn()({**s0, "u": u})["u"], (s0["u"],),
                              (tangent,))
    jvp_err = _check_close("MiniDycore jvp vs plain", tang, rtang, RTOL_F32, ATOL_F32)[0]
    print(f"MiniDycore 512x512x80 f32 torch.func.jvp (kernels under K8 {jvp_counts}) vs the "
          f"plain executor's: max abs {jvp_err:.3e}, bitwise {torch.equal(tang, rtang)}")

    # central differences at 64x256x16 float64
    small, small_plain = models["f64"]
    sstate = small.init_state(seed=1)
    sstep = small.step_fn()
    gu, gq = _full_grad(sstep, sstate)
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

    routed = _routed_gradient(fvm_case)
    kbytes = sum(counts[n][1] * _k8_bytes(st.analysis, (NI, NJ, NK)) for n, st in path.items())
    entry = {
        "name": "K8 kernel_call (autodiff): FullDycore step gradient",
        "route": "cuda",
        "source": "gt4py_tpu_torch/cartesian/backend/autodiff.py",
        "replaces": REPLACES["autodiff"],
        "launches": sum(n for _, n in counts.values()),
        "max_abs_err": max(errs.values()),
        "ms": t["cuda fwd+bwd"],
        "plain_ms": t["torch fwd+bwd"],
        "bound_ms": _bound_ms(kbytes),
        "bound_by": "bytes",
        "library_ms": None,
    }
    summary = {"launches": counts, "max_abs_err": errs, "bitwise": bitwise, "times_ms": t,
               "memory": peak, "jvp_max_abs_err": jvp_err, "small_max_abs_err": small_err,
               "fd_rel": rel, "routed": routed, "card": smi}
    return {"entry": entry, "summary": summary}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gt4py_tpu_torch import testing
    from gt4py_tpu_torch.cartesian import gtscript
    from gt4py_tpu_torch.cartesian.backend import _build
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import REPLACES
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
    next_cases = {key: bench_cases(c["dtype"], c["shape"], dev) for key, c in configs.items()}
    next_kernels = [b for cases in next_cases.values() for case in cases.values()
                    for b in case["kernels"]()]
    t0 = time.perf_counter()
    n_sources = build_all(
        [st.backend for st in main_stencils + list(surface_stencils.values()) + bf16_stencils]
        + next_kernels + [benes.KERNEL])
    build_s = time.perf_counter() - t0
    print(f"build: {n_sources} sources, {build_s:.2f} s (nvcc in parallel)")
    for st in main_stencils:
        print(f"built {st.name}: {len(st.backend.program.kernels)} kernels, {_ptxas(st)}")

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
    s_two, s_fused = state0, state0
    for _ in range(STEPS):
        s_two = step(s_two)
        s_fused = step_fused(s_fused)
    torch.cuda.synchronize()
    launches = {name: st.backend.launches for name, st in path.items()}
    print(f"MiniDycore path launches over {STEPS} steps of each form: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"MiniDycore path never launched the {name} kernels")

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

    points = NI * NJ * NK
    step_ms = {
        "MiniDycore step cuda": _time_ms(lambda: step(state0), TIMING_REPS),
        "MiniDycore step plain": _time_ms(lambda: p_step(state0), PLAIN_TIMING_REPS),
        "MiniDycore fused step cuda": _time_ms(lambda: step_fused(state0), TIMING_REPS),
        "MiniDycore fused step plain": _time_ms(lambda: p_step_fused(state0), PLAIN_TIMING_REPS),
    }
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

    # -- 5. the language surface (float64) ----------------------------------
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
        dt = next(iter(args.values())).dtype
        print(f"surface {feature}: {len(names)} stencils, {total} launches, max abs err "
              f"{worst:.3e} (rtol {RTOL_F64}, atol {ATOL_F64}); "
              f"{SURFACE_TIMED[feature]} at 512x512x80 {dt}, J contiguous (outputs copied "
              f"per call): kernel {timed['cuda']:.4f} ms, plain {timed['torch']:.4f} ms")
        kernels.append({
            "name": f"{feature}: " + ", ".join(names),
            "route": "cuda",
            "source": "gt4py_tpu_torch/cartesian/backend/cuda_backend.py",
            "replaces": REPLACES.get(feature, REPLACES["rows"] + "; " + REPLACES["columns"]),
            "launches": total,
            "max_abs_err": worst,
            "ms": timed["cuda"],
            "plain_ms": timed["torch"],
            **_bound(st.analysis, (NI, NJ, NK)),
        })

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
    print(f"fv_step f32: {len(prog.kernels)} row-form stages, {len(prog.scratch)} scratch "
          f"temporaries ({scratch_bytes / 1e9:.3f} GB at 512x512x80), {len(prog.locals)} in "
          f"registers; {_ptxas(fd.fv.fv_step)}")

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

    print(smi)
    print(json.dumps({"kernels": kernels, "unstructured_fvm": fvm["summary"],
                      "bfloat16": bf16_result, "gradients": gradients["summary"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
