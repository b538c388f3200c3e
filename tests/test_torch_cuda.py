"""The generated CUDA kernels on the card, against the plain executor.

Every test here needs a CUDA device and skips without one.  The file
imports only the port (no ``jax``, no ``gt4py_tpu``), so it also runs on a
GPU machine without JAX:

    GT4PY_TPU_TEST_PLATFORM=gpu python -m pytest -m cuda tests/test_torch_cuda.py

The CPU tests hold the plain executor to the numpy oracle; these hold the
kernels to the plain executor on the same card: the dycore stencils, the
emitters on other IR, every canonical stencil of
``tests/cartesian/stencil_defs.py`` (``while``, regions, variable and
absolute K, data dimensions included), K3's staged windows (whole column,
ring, K origin), FvAdvection, the semi-Lagrangian
stencil and FullDycore, and gradients on the kernels (K8: the forward,
the adjoint and the tangent stencils) and through K9.  The kernels are
built without FMA contraction, so in both float64 and float32 they agree
with it bit for bit; the tolerances below are the stated bounds.  The
adjoint kernels gather each point's terms in another order than
autograd's scatter: their gradients are held to ``GRAD_TOL_F32``.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import testing
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)
from gt4py_tpu_torch.models import (dycore, full_dycore, fv_advection, semi_lagrangian,
                                    shallow_water)

TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=1e-6, atol=1e-7)}
#: float32 gradients on the adjoint kernels against the plain backward:
#: rtol, and atol as a share of the largest entry (sums of terms of both
#: signs, added in another order); measured on an H100 80GB HBM3 at 700 W at
#: 512x512x80 (``chip_smoke.py --k8``): 2.2e-7 of the largest entry at most
GRAD_TOL_F32 = dict(rtol=1e-5, atol_share=1e-6)
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


@pytest.mark.cuda
def test_float16_storage_vs_plain(cuda_device):
    """float16 fields: ``__half`` loads and stores around float compute, in
    the row and the column form, equal to the plain executor exactly."""
    rng = np.random.default_rng(16)
    shape = (40, 70, 9)
    inputs = {"inp": rng.random(shape), "coeff": 0.025 * rng.random(shape),
              "out": np.zeros(shape), "col": np.zeros(shape)}
    got = {}
    for backend in ("cuda", "torch"):
        st = gtscript.stencil(backend=backend, definition=testing.float16_hdiff_sweep,
                              rebuild=True)
        tensors = {k: torch.from_numpy(v.astype(np.float16)).to(cuda_device)
                   for k, v in inputs.items()}
        st(**tensors, origin=(2, 2, 0), domain=(36, 66, 9))
        if backend == "cuda":
            torch.cuda.synchronize()
            assert st.backend.launches == 1
        got[backend] = tensors
    for k in ("out", "col"):
        torch.testing.assert_close(got["cuda"][k], got["torch"][k], rtol=0, atol=0, msg=k)


@pytest.mark.cuda
def test_bfloat16_storage_vs_plain(cuda_device):
    """bfloat16 fields: ``__nv_bfloat16`` loads and stores around float
    compute, in the row and the column form, equal to the plain executor
    exactly."""
    rng = np.random.default_rng(17)
    shape = (40, 70, 9)
    inputs = {"inp": rng.random(shape), "coeff": 0.025 * rng.random(shape),
              "out": np.zeros(shape), "col": np.zeros(shape)}
    got = {}
    for backend in ("cuda", "torch"):
        st = gtscript.stencil(backend=backend, definition=testing.bfloat16_hdiff_sweep,
                              rebuild=True)
        tensors = {k: torch.from_numpy(v).to(cuda_device).to(torch.bfloat16)
                   for k, v in inputs.items()}
        st(**tensors, origin=(2, 2, 0), domain=(36, 66, 9))
        if backend == "cuda":
            torch.cuda.synchronize()
            assert st.backend.launches == 1
        got[backend] = tensors
    for k in ("out", "col"):
        torch.testing.assert_close(got["cuda"][k], got["torch"][k], rtol=0, atol=0, msg=k)


# --------------------------------------------------------------------- #
# the language surface: every canonical stencil (tests/cartesian/
# stencil_defs.py, loaded onto the port) and the .at(K=...), variable-K
# and data-dimension forms of gt4py_tpu_torch.testing.SURFACE
# --------------------------------------------------------------------- #

REGISTRY = testing.load_stencil_defs()
CASES = {**{f"defs_{n}": testing.registry_case(e) for n, e in sorted(REGISTRY.items())},
         **{f"surface_{n}": c for n, c in testing.SURFACE.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_language_surface_vs_plain(cuda_device, name):
    got, ref, st = testing.run_pair(*CASES[name], cuda_device)
    torch.cuda.synchronize()
    assert st.backend.launches == 1
    for k, v in ref.items():
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k], v, rtol=1e-11, atol=1e-13, msg=k)


# --------------------------------------------------------------------- #
# FvAdvection, the semi-Lagrangian stencil and FullDycore
# --------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
def test_fv_step_vs_plain(cuda_device, aligned, dtype):
    out = {}
    for backend in ("cuda", "torch"):
        fv = fv_advection.FvAdvection(24, 40, 6, dtype=dtype, backend=backend, aligned=aligned,
                                      device=cuda_device)
        s = fv.init_state(seed=3)
        step = fv.step_fn()
        q = s["q"]
        for _ in range(3):
            q = step(q, s["cx"], s["cy"])
        out[backend] = q
    torch.testing.assert_close(out["cuda"], out["torch"], **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_sl_stencil_vs_plain(cuda_device, dtype):
    rng = np.random.default_rng(4)
    shape = SHAPE
    args = {n: torch.from_numpy((scale * rng.random(shape)).astype(dtype)).to(cuda_device)
            for n, scale in (("q", 1.0), ("u", 0.8), ("v", -0.8))}
    out = {}
    for backend in ("cuda", "torch"):
        st = semi_lagrangian.make_sl_stencil(dtype, backend=backend)
        fn = st.functional(origin=ORIGIN, domain=DOMAIN, physical_layout=True,
                           periodic=("I", "J"))
        out[backend] = fn(**args, qout=torch.zeros_like(args["q"]), dtdx=0.7,
                          dtdy=1.0)["qout"]
    torch.testing.assert_close(out["cuda"], out["torch"], **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_full_dycore_three_steps_vs_plain(cuda_device, dtype):
    got = {}
    for backend in ("cuda", "torch"):
        m = full_dycore.FullDycore(24, 40, 8, dtype=dtype, backend=backend,
                                   device=cuda_device)
        state = m.init_state(seed=2)
        step = m.step_fn()
        for _ in range(3):
            state = step(state)
        got[backend] = state
    for k, v in got["torch"].items():
        torch.testing.assert_close(got["cuda"][k], v, **TOL[dtype], msg=k)


# --------------------------------------------------------------------- #
# the next DSL through cuda_bridge: bench.py's configurations
# --------------------------------------------------------------------- #

NEXT_CASES = ["hdiff", "hdiff_kcontig", "hdiff_prog_fused", "hdiff_prog_statementwise",
              "mixed_prog_fused", "mixed_prog_statementwise", "tridiag"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", NEXT_CASES)
def test_next_bench_cases_vs_embedded(cuda_device, name, dtype):
    """``with_backend("cuda")`` launches every planned kernel and agrees
    with the embedded ``with_backend("torch")`` on the card, with no
    operator falling back."""
    from gt4py_tpu_torch.next import cuda_bridge
    from gt4py_tpu_torch.next.testing import bench_cases, program_fusion

    cur = cuda_bridge.FALLBACK_EVENTS.cursor()
    cases = bench_cases(dtype, (24, 40, 7), cuda_device)
    case = cases[name]
    with program_fusion(case["fusion"]):
        case["kernels"]()
        got = case["run"]("cuda")
        torch.cuda.synchronize()
        ref = (cases["hdiff"] if name == "hdiff_kcontig" else case)["run"]("torch")
    counts = [k.launches for obj in case["objs"] for k in cuda_bridge.kernels_of(obj)]
    assert counts and min(counts) >= 1
    assert cuda_bridge.FALLBACK_EVENTS.since(cur) == []
    for k, v in ref.items():
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k], v, **TOL[dtype], msg=k)


# --------------------------------------------------------------------- #
# K9: the Beneš butterfly, and the unstructured FVM step that runs it
# --------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 256, 1 << 13, (1 << 13) + 5, 1 << 17, (1 << 17) + 311],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint32],
                         ids=["f32", "i32", "u32"])
def test_benes_kernel_bitwise(cuda_device, P, dtype):
    """The kernel against ``x[sigma]`` and its plain version on the card,
    bit for bit, NaN-aliasing patterns included; it launches once."""
    from gt4py_tpu_torch.next import benes

    rng = np.random.default_rng(P)
    sigma = rng.permutation(P)
    keys = np.empty(P, np.int64)
    keys[sigma] = np.arange(P)
    words = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    words[:6] = [0x7F800001, 0x7FC00000, 0x7F800000, 0xFF800000, 0x80000000,
                 0xFFFFFFFF][:P if P < 6 else 6]
    x = torch.from_numpy(words.view(np.int32)).to(cuda_device).view(dtype)
    before = benes.KERNEL.launches
    got = benes.permute(x, keys.astype(np.int32))
    torch.cuda.synchronize()
    assert benes.KERNEL.launches == before + 1
    # indexed as int32 words: torch has no uint32 gather on CUDA
    ref = x.view(torch.int32)[torch.from_numpy(sigma).to(cuda_device)]
    assert torch.equal(got.view(torch.int32), ref)
    plan = benes._plan(keys.astype(np.int32))
    plain = torch.zeros(plan.n2, dtype=torch.int32, device=cuda_device)
    plain[:P] = x.view(torch.int32)
    benes.plain_inplace(plain, plan)
    assert torch.equal(got.view(torch.int32), plain[:P])


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1 << 20, 1 << 24], ids=["2^20", "2^24"])
def test_benes_kernel_three_passes(cuda_device, P):
    """At the FVM's size and at the largest the network takes: three
    device launches per permute (the outer passes and the inner one),
    bit for bit equal to ``x[sigma]`` and to the plain version, and the
    inverse plan brings the words back."""
    from gt4py_tpu_torch.next import benes

    rng = np.random.default_rng(P + 3)
    sigma = rng.permutation(P)
    keys = np.empty(P, np.int64)
    keys[sigma] = np.arange(P)
    keys = keys.astype(np.int32)
    words = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    plan = benes._plan(keys)
    assert plan.launches == 3 and plan.b < plan.k, plan.record()
    benes.KERNEL.build()
    before = benes.KERNEL.launches, benes.KERNEL.device_launches
    got = benes.permute(x, keys)
    torch.cuda.synchronize()
    assert benes.KERNEL.launches == before[0] + 1
    assert benes.KERNEL.device_launches == before[1] + 3
    assert torch.equal(got, x[torch.from_numpy(sigma).to(cuda_device)])
    plain = torch.zeros(plan.n2, dtype=torch.int32, device=cuda_device)
    plain[:P] = x
    benes.plain_inplace(plain, plan)
    assert torch.equal(got, plain[:P])
    back = benes.KERNEL.launch(got, benes._inverse_plan(plan, keys))
    assert torch.equal(back, x)


@pytest.mark.cuda
@pytest.mark.parametrize("irregular", [False, True], ids=["grid", "shuffled"])
def test_unstructured_fvm_step_routed_vs_index(cuda_device, irregular):
    """Five FVM steps on the card: the shuffled mesh's gathers launch K9,
    the grid mesh's run as windows; both equal the index path bit for
    bit."""
    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.next import benes
    from gt4py_tpu_torch.next.testing import unstructured_fvm_case

    case = unstructured_fvm_case(192, irregular, np.float32, cuda_device)
    before = benes.KERNEL.launches
    routed = case["psi0"]
    for _ in range(5):
        routed = case["step"](routed)
    torch.cuda.synchronize()
    assert (benes.KERNEL.launches > before) == irregular
    saved = config.AFFINE_GATHER, config.SORT_GATHER
    config.AFFINE_GATHER = config.SORT_GATHER = False
    try:
        index = case["psi0"]
        for _ in range(5):
            index = case["step"](index)
    finally:
        config.AFFINE_GATHER, config.SORT_GATHER = saved
    assert bool(torch.isfinite(routed).all())
    assert torch.equal(routed, index)


# --------------------------------------------------------------------- #
# K8: derivatives through the kernels (the forward launches them, the
# adjoint and tangent stencils give the derivative); tests/test_torch_autodiff.py
# and tests/test_torch_derivative.py run the same cases on the emulated kernels
# --------------------------------------------------------------------- #


def weighted_scan(inp: F64, out: F64, *, w: np.float64):
    with computation(FORWARD):
        with interval(0, 1):
            out = w * inp
        with interval(1, None):
            out = out[0, 0, -1] + w * inp


#: stencil -> (factory, the call as the models make it, scalars, the
#: inputs differentiated)
K8_CASES = {
    "hdiff": (dycore.make_hdiff, dict(in_field="u", out_field="u", coeff="coeff"),
              {}, ("u", "coeff")),
    "vadv_update": (dycore.make_vadv_update,
                    dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="x",
                         utens="utens", u_out="u"), {"dtr_stage": 3.0},
                    ("utens_stage", "x", "wcon", "u")),
    "weighted_scan": (lambda dtype, backend: gtscript.stencil(
        backend=backend, definition=weighted_scan, name=f"weighted_scan_{backend}"),
        dict(inp="x", out="u"), {"w": 1.3}, ("x", "u", "w")),
}


def k8_counts(st, since=(0, 0)):
    """A stencil's kernel launches and K8 engagements since ``since``."""
    return (st.backend.launches - since[0], st.backend.derivative_calls - since[1])


def k8_call(name, backend, device):
    """The stencil and ``run(buffers, w=None) -> loss``, the sum of squares
    of its outputs on ``_buffers``' physical (K, I, J) fields (the scan on
    their logical (I, J, K) views), periodic where the models call it so."""
    factory, call, scalars, wrt = K8_CASES[name]
    st = factory(np.float64, backend=backend)
    physical = name != "weighted_scan"
    fn = st.functional(origin=ORIGIN, domain=DOMAIN, physical_layout=physical,
                       periodic=("I", "J") if physical else ())

    def run(bufs, w=None):
        if not physical:
            bufs = {k: v.permute(1, 2, 0) for k, v in bufs.items()}
        sc = dict(scalars, **({"w": w} if w is not None else {}))
        outs = fn(**{a: bufs[b] for a, b in call.items()}, **sc)
        return sum((o ** 2).sum() for o in outs.values())

    return st, run, wrt


def k8_derivatives(name, backend, device):
    """The stencil, then the gradient, ``torch.func.jvp`` (value and
    tangent) and forward-mode tangent of ``k8_call``'s loss with respect to
    the case's differentiated inputs."""
    import torch.autograd.forward_ad as fwAD

    st, run, wrt = k8_call(name, backend, device)
    bufs = _buffers(np.float64, device, seed=7)
    prims = [torch.tensor(1.3, dtype=torch.float64, device=device) if n == "w" else bufs[n]
             for n in wrt]
    rng = np.random.default_rng(9)
    tans = [torch.ones_like(p) if p.ndim == 0 else torch.from_numpy(rng.random(SHAPE)).to(device)
            for p in prims]

    def f(*xs):
        b = dict(bufs)
        b.update({n: x for n, x in zip(wrt, xs) if n != "w"})
        return run(b, xs[wrt.index("w")] if "w" in wrt else None)

    leaves = [p.clone().requires_grad_() for p in prims]
    grads = torch.autograd.grad(f(*leaves), leaves)
    value, tang = torch.func.jvp(f, tuple(prims), tuple(tans))
    with fwAD.dual_level():
        tang_fw = fwAD.unpack_dual(f(*[fwAD.make_dual(p, t) for p, t in zip(prims, tans)])).tangent
    return st, grads, value, tang, tang_fw


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_kernels_vs_plain(cuda_device, name):
    """Gradient, torch.func.jvp and forward-mode tangent with the forward
    on the kernels (each call one launch, under K8) against the plain
    executor on the card."""
    start = k8_counts(K8_CASES[name][0](np.float64, backend="cuda"))
    st, grads, value, tang, tang_fw = k8_derivatives(name, "cuda", cuda_device)
    torch.cuda.synchronize()
    assert k8_counts(st, start) == (3, 3)
    _, rgrads, rvalue, rtang, rtang_fw = k8_derivatives(name, "torch", cuda_device)
    for g, r in zip(grads, rgrads):
        assert g.device.type == "cuda" and float(g.abs().max()) > 0
        torch.testing.assert_close(g, r, **TOL[np.float64])
    for a, b in ((value, rvalue), (tang, rtang), (tang_fw, rtang_fw)):
        torch.testing.assert_close(a, b, **TOL[np.float64])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vadv_update", "weighted_scan"])
def test_k8_second_order_vs_plain(cuda_device, name):
    """A Hessian-vector product, ``torch.func.jvp`` of ``torch.func.grad``,
    with the forward on the kernels: the backward on the adjoint kernels and
    its tangent on the adjoint stencil's tangent kernels, against the plain
    executor's on the card."""
    got = {}
    for backend in ("cuda", "torch"):
        st, run, wrt = k8_call(name, backend, cuda_device)
        bufs = _buffers(np.float64, cuda_device, seed=7)
        x = bufs["x"]
        v = torch.from_numpy(np.random.default_rng(11).random(SHAPE)).to(cuda_device)
        grad = torch.func.grad(lambda x: run({**bufs, "x": x}))
        got[backend] = torch.func.jvp(grad, (x,), (v,))[1]
        if backend == "cuda":
            (adj,) = [b for b in st.backend.derivative_backends()["adjoint"]
                      if b.tangent_calls]
            assert adj.plain_reruns == 0 and adj.derivative_backends()["tangent"]
    assert float(got["torch"].abs().max()) > 0
    torch.testing.assert_close(got["cuda"], got["torch"], **TOL[np.float64])


@pytest.mark.cuda
def test_k8_engages_only_for_derivatives(cuda_device):
    """Under no_grad, or with no input that requires grad, the kernels run
    alone (one launch per call, K8 not engaged)."""
    st, run, _ = k8_call("vadv_update", "cuda", cuda_device)
    start = k8_counts(st)
    bufs = _buffers(np.float64, cuda_device, seed=7)
    plain = run(bufs)
    with torch.no_grad():
        assert torch.equal(run({**bufs, "u": bufs["u"].clone().requires_grad_()}), plain)
    assert k8_counts(st, start) == (2, 0)
    loss = run({**bufs, "u": bufs["u"].clone().requires_grad_()})
    assert loss.requires_grad and torch.equal(loss.detach(), plain)
    assert k8_counts(st, start) == (3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_k8_full_dycore_grad_vs_plain(cuda_device, dtype):
    """The FullDycore step's gradient with respect to the initial u and q,
    forward on the kernels (hdiff, vadv_update and fv_step under K8, their
    backward on their adjoint kernels; sl_step reads neither, so it runs
    alone), against the plain executor's."""
    got = {}
    for backend in ("cuda", "torch"):
        m = full_dycore.FullDycore(24, 40, 8, dtype=dtype, backend=backend,
                                   device=cuda_device)
        path = (m.dyn.hdiff, m.dyn.vadv_upd, m.fv.fv_step, m.sl)
        start = [k8_counts(st) for st in path] if backend == "cuda" else None
        adj = [(st.backend.adjoint_calls, st.backend.plain_reruns) for st in path[:3]] \
            if backend == "cuda" else None
        state = m.init_state(seed=2)
        u, q = (state[k].clone().requires_grad_() for k in ("u", "q"))
        out = m.step_fn()({**state, "u": u, "q": q})
        loss = sum((out[k] ** 2).sum() for k in ("u", "q", "qsl"))
        got[backend] = torch.autograd.grad(loss, (u, q))
        if backend == "cuda":
            counts = [k8_counts(st, s) for st, s in zip(path, start)]
            assert counts == [(1, 1), (1, 1), (1, 1), (1, 0)]
            # each backward on its adjoint kernels, none on the plain re-run
            assert [(st.backend.adjoint_calls - a, st.backend.plain_reruns - r)
                    for st, (a, r) in zip(path, adj)] == [(1, 0)] * 3
    for g, r in zip(got["cuda"], got["torch"]):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        tol = TOL[dtype] if dtype == np.float64 else dict(
            rtol=GRAD_TOL_F32["rtol"], atol=GRAD_TOL_F32["atol_share"] * float(r.abs().max()))
        torch.testing.assert_close(g, r, **tol)


@pytest.mark.cuda
def test_k9_backward_routed_vs_index(cuda_device):
    """The routed FVM energy's gradient: K9 runs once for each forward
    permute and once, on the inverse plan, for each backward one; the
    gradient equals the index path's."""
    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.next import as_field, benes
    from gt4py_tpu_torch.next.testing import Vertex, unstructured_fvm_case

    def grad(case):
        psi = case["psi0"].clone().requires_grad_()
        g = case["gradient"](as_field((Vertex,), psi), offset_provider=case["provider"])
        d = case["divergence"](g, case["sign"], offset_provider=case["provider"])
        return torch.autograd.grad((d.data ** 2).sum(), psi)[0]

    case = unstructured_fvm_case(192, True, np.float32, cuda_device)
    with torch.no_grad():
        case["step"](case["psi0"])  # plans the gathers
    before = benes.KERNEL.launches
    with torch.no_grad():
        case["step"](case["psi0"])
    forward = benes.KERNEL.launches - before
    before = benes.KERNEL.launches
    routed = grad(case)
    torch.cuda.synchronize()
    assert forward > 0 and benes.KERNEL.launches - before == 2 * forward
    saved = config.AFFINE_GATHER, config.SORT_GATHER
    config.AFFINE_GATHER = config.SORT_GATHER = False
    try:
        index = grad(unstructured_fvm_case(192, True, np.float32, cuda_device))
    finally:
        config.AFFINE_GATHER, config.SORT_GATHER = saved
    torch.testing.assert_close(routed, index, rtol=1e-5, atol=0)


# --------------------------------------------------------------------------- #
# the plane-sweep form (K5, and fault 1's loops) and K-blocked passes (K4)
# --------------------------------------------------------------------------- #

P64 = gtscript.Field[np.float64]


def plane_sweep(a: P64, b: P64):
    with computation(FORWARD), interval(...):
        t = a + 1.0
        b = t[1, 0, 0]


def plane_carried(a: P64, c: P64):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t[1, 0, 0] + t[0, -1, 0]
        with interval(1, None):
            t = t[0, 0, -1] * 0.5 + a
            c = t[1, 0, 0] + t[0, -1, 0]


def plane_ahead(a: P64, c: P64):
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


def plane_mixed(a: P64, b: P64, out: P64):
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


def deep_scan(a: P64, out: P64):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, 700):
            out = out[0, 0, -1] * 0.5 + a
        with interval(700, None):
            out = out[0, 0, -1] * 0.25 + 2.0 * a
    with computation(BACKWARD):
        with interval(0, -1):
            out = out + 0.5 * out[0, 0, 1]


def _card_run(defn, shape, domain, device, backend="cuda", periodic=(), **options):
    st = gtscript.stencil(backend=backend, definition=defn, rebuild=True, **options)
    rng = np.random.default_rng(4)
    fields = {n: torch.from_numpy(rng.random(shape)).to(device) for n in st.field_info}
    st(**fields, origin=(2, 2, 0), domain=domain, periodic=periodic)
    torch.cuda.synchronize()
    return st, fields


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["plain", "periodic"])
@pytest.mark.parametrize("defn", [plane_sweep, plane_carried, plane_ahead, plane_mixed],
                         ids=lambda d: d.__name__)
def test_plane_form_vs_plain(cuda_device, defn, periodic):
    """Fault 1's loop, a K-carried temporary read at offsets (a ring of
    planes), reads of values the sweep has not written yet (the copy taken
    before the kernel) and a mixed stencil serialized (K5, ``sweep=True``:
    the PARALLEL loop and the serial loops in one sweep kernel): the
    plane-sweep and sweep kernels against the plain executor on the card,
    at 70 x 90 (several tiles)."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    shape, domain = (74, 94, 9), (70, 90, 9)
    mixed = defn is plane_mixed
    st, got = _card_run(defn, shape, domain, cuda_device, periodic=periodic,
                        **({"sweep": True} if mixed else {}))
    forms = cuda_backend.LAST_PLAN[defn.__name__]["forms"]
    assert forms == ["sweep"] if mixed else "planes" in forms, forms
    assert st.backend.launches == 1
    _, ref = _card_run(defn, shape, domain, cuda_device, backend="torch", periodic=periodic)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, **TOL[np.float64], msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_fused_dycore_forms_vs_plain(cuda_device, dtype):
    """``step_fn(fused=True)`` in the sweep form (``sweep=True``: one
    kernel a call), the plane-sweep form (``serialize=True``)
    and the split build (the default): three steps each against the plain
    executor; the forms from ``LAST_PLAN``, the sweep's one launch a call
    from its library."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    forms = {"sweep": ["sweep"], "planes": ["planes", "column"], "split": ["tile", "column"]}
    got = {}
    for label, backend, options in (("sweep", "cuda", {"sweep": True}),
                                    ("planes", "cuda", {"serialize": True}),
                                    ("split", "cuda", {}),
                                    ("plain", "torch", {})):
        md = dycore.MiniDycore(40, 70, 8, dtype=dtype, backend=backend, device=cuda_device,
                               options=options)
        state = md.init_state(seed=2)
        step = md.step_fn(fused=True)
        if backend == "cuda":
            md.fused.backend.build()  # the count belongs to the library of its source
        before = md.fused.backend.device_launches()["all"] if backend == "cuda" else 0
        for _ in range(3):
            state = step(state)
        got[label] = state
        if backend == "cuda":
            torch.cuda.synchronize()
            assert cuda_backend.LAST_PLAN[md.fused.name]["forms"] == forms[label], label
            counted = md.fused.backend.device_launches()["all"] - before
            assert counted == 3 * len(forms[label]), (label, counted)
    for k in ("u", "utens_stage"):
        for label in ("sweep", "planes", "split"):
            torch.testing.assert_close(got[label][k], got["plain"][k], **TOL[dtype],
                                       msg=f"{label} {k}")


@pytest.mark.cuda
def test_kblocked_vs_one_pass_and_plain(cuda_device):
    """K4 at dK 2000: the K-blocked kernels (blocks of the planned KB)
    against the one-pass column form and the K-blocked plain counterpart."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    shape, domain = (36, 70, 2000), (32, 66, 2000)
    st, got = _card_run(deep_scan, shape, domain, cuda_device, k_blocked=True)
    plan = cuda_backend.LAST_PLAN["deep_scan"]
    # the forward loop stages ``a`` in blocks; the backward one reads only
    # what it writes, stages nothing and runs as one block; one launch per
    # loop, a ring of two slots, at least 4 CTAs on a SM
    kb = plan["kblocked"]
    assert kb and kb["KB"][0] < 2000 and set(kb["launches_per_loop"]) == {1}, plan
    assert kb["slots"][0] == 2 and min(kb["ctas_per_sm"]) >= 4, plan
    _, one = _card_run(deep_scan, shape, domain, cuda_device, k_blocked=False)
    rng = np.random.default_rng(4)
    plain = {n: torch.from_numpy(rng.random(shape)).to(cuda_device) for n in st.field_info}
    testing.plain_kblocked(st, plain, {}, (2, 2, 0), domain)
    for k in got:
        torch.testing.assert_close(got[k], one[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(got[k], plain[k], **TOL[np.float64], msg=k)


@pytest.mark.cuda
def test_torch_func_grad_through_k8(cuda_device):
    """``torch.func.grad`` and ``torch.func.vjp`` of a MiniDycore step loss
    with the forward on the kernels equal ``torch.autograd.grad``."""
    md = dycore.MiniDycore(24, 40, 8, dtype=np.float64, backend="cuda", device=cuda_device)
    s0 = md.init_state(seed=1)
    step = md.step_fn()

    def loss(u):
        return (step({**s0, "u": u})["u"] ** 2).sum()

    u = s0["u"].clone().requires_grad_()
    ref = torch.autograd.grad(loss(u), u)[0]
    assert torch.equal(torch.func.grad(loss)(s0["u"]), ref)
    out, pull = torch.func.vjp(loss, s0["u"])
    assert torch.equal(pull(torch.ones_like(out))[0], ref)


def plane_ring(a: P64, c: P64):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, -1]
            t = a * 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["plain", "periodic"])
def test_plane_ring_widened_vs_plain(cuda_device, periodic):
    """A ring read at points its writer does not compute: the writer is
    widened (``LAST_PLAN[...]["widened"]``), bit for bit against plain."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    shape, domain = (74, 94, 9), (70, 90, 9)
    st, got = _card_run(plane_ring, shape, domain, cuda_device, periodic=periodic)
    assert cuda_backend.LAST_PLAN["plane_ring"]["widened"] == {"t": [[0, 1], [0, 0]]}
    _, ref = _card_run(plane_ring, shape, domain, cuda_device, backend="torch", periodic=periodic)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_k6_vector_and_repair_vs_plain(cuda_device, dtype):
    """K6: hdiff's tile kernel on halo-3 buffers with J rows of 77 items
    (no whole number of 16-byte words in float32 or float64: its rows on
    two phases) and halo-2 ones of 76 (one phase), its input staged from
    each row's aligned-down word with no copy, and with the repair forced
    (``repair=True``, halo 3), against the scalar build and the plain
    executor, bit for bit."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    rng = np.random.default_rng(6)
    for halo, nj in ((3, 71), (2, 72)):
        shape = (9, 20 + 2 * halo, nj + 2 * halo)
        u = torch.from_numpy(rng.random(shape).astype(dtype)).to(cuda_device)
        c = torch.from_numpy(0.025 * rng.random(shape).astype(dtype)).to(cuda_device)
        kw = dict(origin=(halo, halo, 0), domain=(20, nj, 9), physical_layout=True)
        got = {}
        runs = [("vector", "cuda", {"vector": True}), ("scalar", "cuda", {"vector": False})]
        if halo == 3:
            runs.append(("repair", "cuda", {"repair": True}))
        for label, backend, options in runs + [("plain", "torch", {})]:
            st = dycore.make_hdiff(dtype, backend, **options)
            got[label] = st.functional(**kw)(in_field=u, out_field=u, coeff=c)["out_field"]
            torch.cuda.synchronize()
            if backend == "cuda":
                plan = cuda_backend.LAST_PLAN[st.name]
                assert plan["vector"] == 16 // np.dtype(dtype).itemsize, plan
                assert plan["staging"] == {"in_field": "row_phase"}, plan
                assert bool(plan.get("repair")) == (label == "repair"), plan
        for label, _, _ in runs:
            assert torch.equal(got[label], got["plain"]), (halo, label)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_k6_row_phase_twins_vs_plain(cuda_device, dtype, periodic):
    """K6: the vector row kernels' row-phase twins (``<stage>_vr``) on
    halo-3 buffers whose J rows of 77 items are no whole number of 16-byte
    words (their rows on two phases), built ``vector=True`` (by default the
    scalar row kernels run there): sl_step's one row stage and hdiff's
    three (``tiles=False``), each row stage launched once as a vector
    kernel by its library's count, no copy, bit for bit against plain."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    rng = np.random.default_rng(7)
    shape = (9, 20 + 2 * H, 71 + 2 * H)
    kw = dict(origin=(H, H, 0), domain=(20, 71, 9), physical_layout=True, periodic=periodic)
    q, u, v, c = (torch.from_numpy(rng.random(shape).astype(dtype)).to(cuda_device)
                  for _ in range(4))
    cases = {
        "sl_step": (lambda b, **o: semi_lagrangian.make_sl_stencil(dtype, b, 1, **o),
                    {"vector": True},
                    dict(q=q, u=u - 0.5, v=v - 0.5, qout=torch.zeros_like(q), dtdx=0.7,
                         dtdy=0.7)),
        "hdiff": (lambda b, **o: dycore.make_hdiff(dtype, b, **o),
                  {"tiles": False, "vector": True},
                  dict(in_field=q, out_field=q, coeff=0.025 * c)),
    }
    for name, (make, options, args) in cases.items():
        st = make("cuda", **options)
        st.backend.build()
        rows = [k.name for k in st.backend.program.kernels if k.form == "rows"]
        before = st.backend.device_launches()
        got = st.functional(**kw)(**args)
        torch.cuda.synchronize()
        now = st.backend.device_launches()
        plan = cuda_backend.LAST_PLAN[st.name]
        assert now["all"] - before["all"] == len(rows), plan
        assert sum(now["vector"]) - sum(before["vector"]) == len(rows), plan
        assert plan["vector_phase"] == "row" and "repair" not in plan, plan
        assert plan["vector_rows"] == [k + "_vr" for k in rows], plan
        ref = make("torch").functional(**kw)(**args)
        for k, t in ref.items():
            assert torch.equal(got[k], t), (name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
def test_shallow_water_vs_plain(cuda_device, aligned):
    """ShallowWater's steps (periodic on aligned buffers, local on halo-2
    ones): three steps on the kernels, bit for bit against plain."""
    from gt4py_tpu_torch.models import ShallowWater

    got = {}
    for backend in ("cuda", "torch"):
        m = ShallowWater(24, 72, 6, dtype=np.float32, backend=backend, aligned=aligned,
                         device=cuda_device)
        s = m.init_state()
        step = m.step_fn() if aligned else m.local_step_fn()
        h, u, v = s["h"], s["u"], s["v"]
        for _ in range(3):
            h, u, v = step(h, u, v)
        got[backend] = (h, u, v)
    for a, b in zip(got["cuda"], got["torch"]):
        assert torch.equal(a, b)


#: the main path's stencils in the tile form (K1) and the fused column
#: kernel (K2): name -> (factory, fields, scalars, forms, kernels the
#: library launches a call, the new form's build options (sl_step's one
#: stage runs the row kernel unless forced), the split build's options)
CARD_TILES = {
    "hdiff": (dycore.make_hdiff, ["in_field", "out_field", "coeff"], {}, ["tile"], 1, {},
              {"tiles": False}),
    "fv_step": (fv_advection.make_fv_step, ["q", "cx", "cy", "qout"], {}, ["tile"], 1, {},
                {"tiles": False}),
    "sw_step": (shallow_water.make_sw_step, ["h", "u", "v", "h_new", "u_new", "v_new"], {},
                ["tile"], 1, {}, {"tiles": False}),
    "sl_step": (semi_lagrangian.make_sl_stencil, ["q", "u", "v", "qout"],
                {"dtdx": 1.0, "dtdy": 1.0}, ["tile"], 1, {"tiles": True}, {"tiles": False}),
    "vadv_update": (dycore.make_vadv_update,
                    ["utens_stage", "u_stage", "wcon", "u_pos", "utens", "u_out"],
                    {"dtr_stage": 3.0}, ["column"], 1, {}, {"fuse_loops": False}),
    "dycore_fused": (dycore.make_dycore_fused,
                     ["u", "coeff", "wcon", "utens", "utens_stage", "u_out"],
                     {"dtr_stage": 3.0}, ["tile", "column"], 2, {},
                     {"fuse_loops": False, "tiles": False}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CARD_TILES))
def test_tiles_and_fused_columns_vs_split_and_plain(cuda_device, name, dtype, periodic):
    """Each main-path stencil's new form -- one tile kernel per PARALLEL
    section, one fused column kernel for the serial loops -- at
    70 x 90 x 9 (several tiles, three K blocks): its forms from ``LAST_PLAN``,
    its kernel launches counted by its library, its result bit for bit
    equal to its split build and to plain."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    make, names, scalars, forms, launches, new, split = CARD_TILES[name]
    rng = np.random.default_rng(6)
    # halo 3 (fv_step reads q at +-3)
    arrays = {n: rng.random((76, 96, 9)).astype(dtype) for n in names}
    got = {}
    for label, backend, options in (("default", "cuda", new), ("split", "cuda", split),
                                    ("plain", "torch", {})):
        st = make(dtype, backend, **options)
        fields = {n: torch.from_numpy(a.copy()).to(cuda_device) for n, a in arrays.items()}
        if backend == "cuda":
            st.backend.build()  # the count belongs to the library of its source
        before = st.backend.device_launches()["all"] if backend == "cuda" else 0
        st(**fields, **scalars, origin=(3, 3, 0), domain=(70, 90, 9), periodic=periodic)
        torch.cuda.synchronize()
        if label == "default":
            plan = cuda_backend.LAST_PLAN[st.name]
            assert plan["forms"] == forms, plan
            assert st.backend.device_launches()["all"] - before == launches
        got[label] = fields
    for n in names:
        assert torch.equal(got["default"][n], got["split"][n]), n
        assert torch.equal(got["default"][n], got["plain"][n]), n


# --------------------------------------------------------------------- #
# K3: the staged form of variable-K reads
# --------------------------------------------------------------------- #


def _vark_gather(dtype):
    F = gtscript.Field[dtype]

    def vark_gather(inp: F, idx: gtscript.Field[np.int64], out: F):
        with computation(PARALLEL), interval(...):
            out = inp[0, 0, idx]

    return vark_gather


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["whole", "ring", "k_origin"])
def test_k3_staged_windows_vs_plain(cuda_device, monkeypatch, case, dtype):
    """The staged kernel at 70 x 90 x 40 in the models' (K, I, J) layout,
    offsets over the whole column: with the whole buffer column in its
    window (no read outside it), with a ring forced by a small
    ``VK_BUDGET`` (reads outside it counted on the device), and at a
    nonzero K origin; each bit for bit equal to plain and to the
    ``stage_vark=False`` build, one launch counted by its library."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    if case == "ring":
        TI, TJ = cuda_backend.VK_TILE
        monkeypatch.setattr(cuda_backend, "VK_BUDGET",
                            cuda_backend.VK_MIN_RING * TI * (TJ + 2) * 8)
    nk, origin, domain = (44, (0, 0, 4), (70, 90, 40)) if case == "k_origin" \
        else (40, (0, 0, 0), (70, 90, 40))
    rng = np.random.default_rng(8)
    inp = rng.random((nk, 70, 90)).astype(dtype)
    idx = rng.integers(-nk, nk + 1, (nk, 70, 90)).astype(np.int64)
    got = {}
    for label, backend, options in (("staged", "cuda", {}), ("parent", "cuda",
                                                         {"stage_vark": False}),
                                    ("plain", "torch", {})):
        st = gtscript.stencil(backend=backend, definition=_vark_gather(dtype), rebuild=True,
                              **options)
        fields = {"inp": torch.from_numpy(inp).to(cuda_device).permute(1, 2, 0),
                  "idx": torch.from_numpy(idx).to(cuda_device).permute(1, 2, 0),
                  "out": torch.zeros((nk, 70, 90), dtype=getattr(torch, np.dtype(dtype).name),
                                     device=cuda_device).permute(1, 2, 0)}
        if backend == "cuda":
            st.backend.build()
        before = st.backend.device_launches()["all"] if backend == "cuda" else 0
        st(**fields, origin=origin, domain=domain)
        torch.cuda.synchronize()
        if label == "staged":
            assert st.backend.device_launches()["all"] - before == 1
            (rec,) = cuda_backend.LAST_PLAN[st.name]["vark"]
            outside = st.backend.outside_reads()[rec["kernel"]]
            assert rec["whole"] == {"inp": case != "ring"}, rec
            assert (outside > 0) == (case == "ring"), outside
        got[label] = fields["out"]
    assert torch.equal(got["staged"], got["plain"])
    assert torch.equal(got["parent"], got["plain"])


# --------------------------------------------------------------------- #
# the differential fuzzers on the card (chip_smoke.py --fuzz runs every
# seed of each leg; here the first eight): cuda against torch on the card
# and both against the numpy oracle
# --------------------------------------------------------------------- #

from gt4py_tpu_torch.testing import gather_fuzz, next_fuzz, program_gen  # noqa: E402

FUZZ_KERNEL_TOL = {np.dtype(np.float64): TOL[np.float64], np.dtype(np.float32): TOL[np.float32]}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("leg", sorted(program_gen.LEGS))
def test_program_fuzz_on_the_card(cuda_device, leg, seed):
    seeds, kw = program_gen.LEGS[leg]
    if seed not in seeds:
        pytest.skip(f"leg {leg} has seeds {seeds}")
    dt = np.dtype(kw.get("dtype", np.float64))
    tol = FUZZ_KERNEL_TOL.get(dt, TOL[np.float32])
    pinned = program_gen.LEG_DECLINES.get((leg, seed))
    case = program_gen.run_differential_case(
        seed, backends=("torch", "cuda"), device=cuda_device, max_flip_fraction=1e-4,
        kernel_rtol=tol["rtol"], kernel_atol=tol["atol"], allow_declines=pinned is not None,
        **kw)
    if pinned is not None:
        assert case.declined is not None and pinned in case.declined, case.declined
    elif not case.rejected:
        assert case.launches >= 1
        assert sum(case.forms.values()) == case.launches


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_next_fuzz_on_the_card(cuda_device, seed):
    next_fuzz.run_differential_case(seed, device=cuda_device)
    next_fuzz.run_program_case(seed, device=cuda_device)
    next_fuzz.run_bridge_case(seed, device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_gather_fuzz_on_the_card(cuda_device, seed):
    outcome, launches = gather_fuzz.run_gather_case(seed, device=cuda_device)
    if outcome == "routed":
        assert launches >= 1
    gather_fuzz.run_chain_case(seed, device=cuda_device)


@pytest.mark.cuda
def test_ring_phased_on_four_ranks_on_the_card(cuda_device, tmp_path):
    """The ring stencil on DistributedFields on four gloo ranks sharing the
    card: one level at a time (as many exchanges as levels), every phase
    on its kernels, bit for bit the single-device ``"cuda"`` run."""
    from gt4py_tpu_torch.testing import dist_cases

    shape = (24, 36, 5)
    got = dist_cases.launch({"ring": dict(shape=shape, backend="cuda")}, workdir=str(tmp_path),
                            device="cuda", strict=True, timeout=300)["ring"][0][1]
    ref = dist_cases.ring_single(shape, backend="cuda", device=cuda_device)
    np.testing.assert_array_equal(got["c"], ref)
    rec = got["record"]
    assert rec["phased"] and rec["exchanges"] == rec["levels"] == shape[2], rec
    assert all(n > 0 for n in got["phase_launches"]) and got["library_launches"] >= shape[2]


@pytest.mark.cuda
def test_cartesian_tutorial_on_the_card(cuda_device):
    """The cartesian tutorial example on the card: every cell, the
    ``"cuda"`` stencils' kernels counted by their libraries."""
    from gt4py_tpu_torch.examples import cartesian_tutorial

    out = cartesian_tutorial.main(device=cuda_device)
    assert out["device"].startswith("cuda") and out["launches"] >= 5, out
    assert out["tridiag_residual"] < 1e-12 and out["backends_max_diff"] <= 1e-12
