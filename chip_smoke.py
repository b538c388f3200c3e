#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: the MiniDycore step on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (a failed phase raises, and the script exits non-zero):

1. require a CUDA device; print the torch, CUDA and nvcc versions and the
   card's name and power limit;
2. build the generated CUDA kernels of the main path from the repository's
   sources (nvcc, sm_90a) and print the build seconds and ptxas' report;
3. kernel against plain on the card: ``backend="cuda"`` against
   ``backend="torch"`` for hdiff, vadv_update and dycore_fused, periodic,
   at 512x512x80 float32 and 64x256x16 float64;
4. the main path: ``MiniDycore(512, 512, 80, float32, backend="cuda")``,
   10 steps of ``step_fn()`` and of ``step_fn(fused=True)``, with the launch
   counts of every kernel read around that run, the state checked finite
   and against the plain executor, and both forms timed with CUDA events.

The line before the last is one JSON object with every kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
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
PLAIN_TIMING_REPS = 3


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _errors(got, ref):
    import torch

    d = (got.double() - ref.double()).abs()
    rel = d / ref.double().abs().clamp_min(1e-30)
    return float(d.max()), float(rel.max())


def _check_close(what, got, ref, rtol, atol):
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
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


def _stencil_calls(md, state, diffused):
    """The three main-path stencils' periodic calls on ``state`` as the
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gt4py_tpu_torch.cartesian.backend import _build
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import REPLACES
    from gt4py_tpu_torch.models import dycore

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
    ni, nj, nk = 512, 512, 80
    configs = {
        "f32": dict(shape=(ni, nj, nk), dtype=np.float32, rtol=RTOL_F32, atol=ATOL_F32),
        "f64": dict(shape=(64, 256, 16), dtype=np.float64, rtol=RTOL_F64, atol=ATOL_F64),
    }
    models = {}
    for key, c in configs.items():
        models[key] = (
            dycore.MiniDycore(*c["shape"], dtype=c["dtype"], backend="cuda", device=dev),
            dycore.MiniDycore(*c["shape"], dtype=c["dtype"], backend="torch", device=dev),
        )
    t0 = time.perf_counter()
    for key, (md, _) in models.items():
        for st in (md.hdiff, md.vadv_upd, md.fused):
            st.backend.build()
            log = open(os.path.join(st.backend.build_dir, "build.log")).read()
            usage = re.findall(r"Function properties for (\S+)|Used (\d+) registers", log)
            regs = [int(r) for _, r in usage if r]
            spills = re.findall(r"(\d+) bytes spill stores", log)
            print(f"built {st.name}: {len(st.backend.program.kernels)} kernels, "
                  f"{st.backend.build_seconds:.2f} s, registers {regs}, "
                  f"spill stores {[int(s) for s in spills]}")
    print(f"build seconds: {time.perf_counter() - t0:.2f}")

    # -- 3. kernel against plain ------------------------------------------
    errors = {}
    for key, (md, md_plain) in models.items():
        c = configs[key]
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

    # -- 4. the main path ---------------------------------------------------
    md, md_plain = models["f32"]
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
    print(f"main path launches over {STEPS} steps of each form: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched the {name} kernels")

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
            print(f"main path {form} {field} after {STEPS} steps vs plain: max abs "
                  f"{e[0]:.3e}, max rel {e[1]:.3e}")
    # the two step forms compute the same step
    _check_close("fused vs two-stencil step", s_fused["u"], s_two["u"], RTOL_F32, ATOL_F32)

    # timings (after the launch counts were read: these launches do not count)
    points = ni * nj * nk
    step_ms = {
        "step cuda": _time_ms(lambda: step(state0), TIMING_REPS),
        "step plain": _time_ms(lambda: p_step(state0), PLAIN_TIMING_REPS),
        "fused step cuda": _time_ms(lambda: step_fused(state0), TIMING_REPS),
        "fused step plain": _time_ms(lambda: p_step_fused(state0), PLAIN_TIMING_REPS),
    }
    for k, ms in step_ms.items():
        print(f"{k}: {ms:.4f} ms per step, {points / ms / 1e6:.3f} Gpoint/s "
              f"(512x512x80 f32, median of CUDA-event times)")
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
        })

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
