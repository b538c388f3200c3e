"""The generated CUDA kernels on the card, against the plain executor.

Every test here needs a CUDA device and skips without one.  The file
imports only the port (no ``jax``, no ``gt4py_tpu``), so it also runs on a
GPU machine without JAX:

    GT4PY_TPU_TEST_PLATFORM=gpu python -m pytest -m cuda tests/test_torch_cuda.py

The CPU tests hold the plain executor to the numpy oracle; these hold the
kernels to the plain executor on the same card.  The kernels are built
without FMA contraction, so in both float64 and float32 they agree with it
bit for bit; the tolerances below are the stated bounds.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)
from gt4py_tpu_torch.models import dycore

TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=1e-6, atol=1e-7)}
H = 3
DOMAIN = (20, 70, 9)
SHAPE = (DOMAIN[2], DOMAIN[0] + 2 * H, DOMAIN[1] + 2 * H)
ORIGIN = (H, H, 0)

CALLS = {
    "make_hdiff": dict(in_field="u", out_field="u", coeff="coeff"),
    "make_vadv": dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="x",
                      utens="utens"),
    "make_vadv_update": dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="x",
                             utens="utens", u_out="u"),
    "make_dycore_fused": dict(u="u", coeff="coeff", wcon="wcon", utens="utens",
                              utens_stage="utens_stage", u_out="u"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _buffers(dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    scale = {"coeff": 0.025, "wcon": 0.2, "utens": 0.01}
    return {n: torch.from_numpy((scale.get(n, 1.0) * rng.random(SHAPE)).astype(dtype)).to(device)
            for n in ("u", "coeff", "wcon", "utens", "utens_stage", "x")}


def _pair(factory, dtype, periodic, device):
    bufs = _buffers(dtype, device, seed=7)
    before = {k: v.clone() for k, v in bufs.items()}
    scalars = {} if factory == "make_hdiff" else {"dtr_stage": 3.0}
    out = {}
    for backend in ("cuda", "torch"):
        st = getattr(dycore, factory)(dtype, backend=backend)
        fn = st.functional(origin=ORIGIN, domain=DOMAIN, physical_layout=True,
                           periodic=periodic)
        launched = getattr(st.backend, "launches", 0)
        out[backend] = fn(**{a: bufs[b] for a, b in CALLS[factory].items()}, **scalars)
        if backend == "cuda":
            torch.cuda.synchronize()
            assert st.backend.launches == launched + 1
    for k, v in bufs.items():  # arguments unchanged, aliased ones included
        assert torch.equal(v, before[k]), k
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["plain", "periodic"])
@pytest.mark.parametrize("factory", list(CALLS))
def test_dycore_kernels_vs_plain(cuda_device, factory, periodic, dtype):
    out = _pair(factory, dtype, periodic, cuda_device)
    assert sorted(out["cuda"]) == sorted(out["torch"])
    for name, t in out["cuda"].items():
        assert t.device.type == "cuda"
        torch.testing.assert_close(t, out["torch"][name], **TOL[dtype], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["two_stencil", "fused"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
def test_three_steps_vs_plain(cuda_device, aligned, fused):
    got = {}
    for backend in ("cuda", "torch"):
        md = dycore.MiniDycore(24, 40, 8, dtype=np.float64, backend=backend,
                               aligned=aligned, device=cuda_device)
        state = md.init_state(seed=2)
        step = md.step_fn(fused=fused)
        for _ in range(3):
            state = step(state)
        got[backend] = state
    for k, v in got["torch"].items():
        torch.testing.assert_close(got["cuda"][k], v, **TOL[np.float64], msg=k)


# --------------------------------------------------------------------- #
# the emitters on other IR: lower-dimensional fields, conditionals, K
# offsets in PARALLEL, integer arithmetic, builtins, runtime intervals
# --------------------------------------------------------------------- #

F64 = gtscript.Field[np.float64]
FI = gtscript.Field[np.int64]
FB = gtscript.Field[np.bool_]
F2 = gtscript.Field[gtscript.IJ, np.float64]


def lower_dim(a: F64, b: F2, *, s: float):
    with computation(PARALLEL), interval(...):
        tmp = a * s
    with computation(FORWARD), interval(0, 1):
        b += tmp


def conditionals(a: F64, b: F64, c: F64, m: FB):
    with computation(PARALLEL), interval(1, -1):
        d = 0.0
        if m and m[0, 0, -1]:
            b = a[0, 0, 1]
        elif m[0, 0, 1]:
            c = a - a[0, 0, -1]
        else:
            d = b - c
        c = c + d * 0.5


def builtins(a: F64, b: F64):
    with computation(PARALLEL), interval(...):
        b = (sqrt(abs(a)) + exp(-a) * sin(a) - min(a, 0.5) + max(a, 0.25) ** 2.0  # noqa: F821
             + floor(a * 3.0) + a % 0.3 + tanh(a) + atan2(a, 0.7))  # noqa: F821


def integers(a: FI, b: FI, c: F64):
    with computation(PARALLEL), interval(...):
        b = a // 3 + a % 5 - (a * I) + J - K + (a > 4) * 2  # noqa: F821
        c = a / 4 + 1.5


def runtime_interval(a: F64, b: F64, *, kmax: np.int64):
    with computation(BACKWARD), interval(0, kmax):
        b = a + b[0, 0, 1]


def tridiagonal(inf: F64, diag: F64, sup: F64, rhs: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]
        with interval(-1, None):
            out = rhs


def temp_reads_unwritten(a: F64, b: F64, c: F64):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(PARALLEL), interval(...):
        b = t[0, 0, 1]  # the top level reads t above the domain: zero
        c = t[1, 0, 0] + t[0, 0, -1]  # ... and the bottom level below it
    with computation(FORWARD), interval(0, 1):
        w = a
    with computation(FORWARD), interval(...):
        b = b + w[0, 0, 1]  # level k + 1 is written one iteration later
        w = a + 1.0


def _inputs(name, device):
    rng = np.random.default_rng(11)
    shp = (9, 10, 7)
    if name == "lower_dim":
        return dict(a=rng.random(shp), b=np.zeros(shp[:2])), dict(s=2.0), {}
    if name == "conditionals":
        return dict(a=rng.random(shp), b=rng.random(shp), c=rng.random(shp),
                    m=rng.random(shp) > 0.5), {}, {}
    if name == "builtins":
        return dict(a=rng.random(shp) * 4 - 2, b=np.zeros(shp)), {}, {}
    if name == "integers":
        return dict(a=rng.integers(-20, 20, shp), b=np.zeros(shp, np.int64),
                    c=np.zeros(shp)), {}, {}
    if name == "temp_reads_unwritten":
        return dict(a=rng.random(shp), b=np.zeros(shp), c=np.zeros(shp)), {}, \
            dict(domain=(8, 10, 7))
    if name == "runtime_interval":
        return dict(a=rng.random(shp), b=rng.random(shp)), dict(kmax=5), \
            dict(domain=(9, 10, 6))
    return dict(inf=rng.random(shp), diag=3 + rng.random(shp), sup=rng.random(shp),
                rhs=rng.random(shp), out=np.zeros(shp)), {}, {}


DEFS = {f.__name__: f for f in (lower_dim, conditionals, builtins, integers,
                                runtime_interval, tridiagonal, temp_reads_unwritten)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DEFS))
def test_emitters_vs_plain(cuda_device, name):
    got = {}
    for backend in ("cuda", "torch"):
        st = gtscript.stencil(backend=backend, definition=DEFS[name], rebuild=True)
        fields, scalars, kw = _inputs(name, cuda_device)
        tensors = {k: torch.from_numpy(v).to(cuda_device) for k, v in fields.items()}
        st(**tensors, **scalars, **kw)
        if backend == "cuda":
            torch.cuda.synchronize()
            assert st.backend.launches == 1
        got[backend] = tensors
    for k, v in got["torch"].items():
        torch.testing.assert_close(got["cuda"][k], v, rtol=1e-11, atol=1e-13, msg=k)
