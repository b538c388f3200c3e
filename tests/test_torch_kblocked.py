"""K4: deep-K serial loops K-blocked on the emulated kernels.

The cases of ``tests/cartesian/test_kblocked.py`` at their shapes (dK 512,
600, 2000 and 2048, and the dK 16 control): the ``"cuda"`` backend runs
each column-form loop once per K block, its read-only inputs staged per
block in shared memory, the carries crossing blocks in the scratch
buffers.  The kernels are built by the host compiler against the emulated
runtime of ``tests/test_torch_emulated.py`` and held to the JAX package's
numpy oracle at rtol 1e-12 (float64), and bit for bit to the one-pass
column form (``k_blocked=False``) and to K4's plain counterpart
(``testing.plain_kblocked``: ``passes.clip_stencil_to_k_block`` block by
block through the plain executor).  ``cuda_backend.LAST_PLAN`` records the
passes, KB and promoted temporaries, or the one-pass plan and its reason.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port

F = jgts.Field[np.float64]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def tridiag(inf: F, diag: F, sup: F, rhs: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def two_pass(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            tmp = a
        with interval(1, None):
            tmp = tmp[0, 0, -1] * 0.5 + a
    with computation(BACKWARD):
        with interval(-1, None):
            out = tmp
        with interval(0, -1):
            out = tmp + 0.25 * out[0, 0, 1]


def with_k(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a * K
        with interval(1, None):
            out = out[0, 0, -1] + a * K


def cumsum(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, None):
            out = out[0, 0, -1] + a


def staged(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, 700):
            out = out[0, 0, -1] + a
        with interval(700, -3):
            out = out[0, 0, -1] + 2.0 * a
        with interval(-3, None):
            out = out[0, 0, -1] - a


def back(a: F, out: F):
    with computation(BACKWARD):
        with interval(-1, None):
            out = a
        with interval(0, -1):
            out = 0.5 * out[0, 0, 1] + a


def two_stmt(inp: F, out: F):
    with computation(PARALLEL):
        with interval(0, -1):
            tmp = inp * 2.0
        with interval(0, -1):
            out = tmp[0, 0, 1]


def _ranges(shape, seed, lo=0.0, hi=1.0):
    return lo + (hi - lo) * np.random.default_rng(seed).random(shape)


#: name -> (definition, inputs, origin, domain, passes, promoted)
CASES = {
    "tridiagonal_dk512": (tridiag, lambda: dict(
        inf=_ranges((12, 12, 512), 1, -0.3, 0.0), diag=_ranges((12, 12, 512), 2, 2.0, 3.0),
        sup=_ranges((12, 12, 512), 3, -0.3, 0.0), rhs=_ranges((12, 12, 512), 4),
        out=np.zeros((12, 12, 512))), (2, 2, 0), (8, 8, 512), 2, []),
    "promoted_cross_loop": (two_pass, lambda: dict(
        a=_ranges((10, 10, 512), 7), out=np.zeros((10, 10, 512))),
        (0, 0, 0), (10, 10, 512), 2, ["tmp"]),
    "axis_position_dk600": (with_k, lambda: dict(
        a=_ranges((9, 9, 600), 11), out=np.zeros((9, 9, 600))), (0, 0, 0), (9, 9, 600), 1, []),
    "ragged_dk2000": (cumsum, lambda: dict(
        a=_ranges((8, 8, 2000), 13), out=np.zeros((8, 8, 2000))),
        (0, 0, 0), (8, 8, 2000), 1, []),
    "sections_dk2048": (staged, lambda: dict(
        a=_ranges((8, 8, 2048), 17), out=np.zeros((8, 8, 2048))),
        (0, 0, 0), (8, 8, 2048), 1, []),
    "backward_dk2048": (back, lambda: dict(
        a=_ranges((8, 8, 2048), 19), out=np.zeros((8, 8, 2048))),
        (0, 0, 0), (8, 8, 2048), 1, []),
}


def _run(defn, arrays, origin, domain, k_blocked=True, **options):
    st = pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True,
                      k_blocked=k_blocked, **options)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    st(**out, origin=origin, domain=domain)
    return st, out


@pytest.mark.parametrize("name", list(CASES))
def test_kblocked_emulated_vs_oracle(emulated, name):  # noqa: F811
    defn, make, origin, domain, n_passes, promoted = CASES[name]
    arrays = make()
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=defn, rebuild=True)(**ref, origin=origin,
                                                                 domain=domain)
    st, got = _run(defn, arrays, origin, domain)
    plan = cuda_backend.LAST_PLAN[defn.__name__]
    kb = plan["kblocked"]
    assert kb and kb["passes"] == n_passes and kb["promoted"] == promoted, plan
    # every column loop blocks the deep column: its window fits one CTA
    assert len(kb["KB"]) == plan["forms"].count("columns") and all(
        8 <= k < domain[2] for k in kb["KB"]), plan
    _, one_pass = _run(defn, arrays, origin, domain, k_blocked=False)
    assert not cuda_backend.LAST_PLAN[defn.__name__]["kblocked"]
    plain = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    testing.plain_kblocked(st, plain, {}, origin, domain)
    for k in arrays:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-12, atol=0, err_msg=k)
        assert torch.equal(got[k], one_pass[k]), k
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 8, 2000)], ids=["dk16", "dk2000"])
def test_one_pass_is_the_default(emulated, shape):  # noqa: F811
    """Without ``k_blocked=True`` a serial stencil runs the one-pass column
    form at any depth (it ran deep K 3x faster on the H100), and the plan
    says why; the dK 16 control K-blocked is one block of 16."""
    arrays = dict(a=_ranges(shape, 23), out=np.zeros(shape))
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=cumsum, rebuild=True)(**ref, origin=(0, 0, 0),
                                                                   domain=shape)
    for k_blocked in (None, True):
        st, got = _run(cumsum, arrays, (0, 0, 0), shape, k_blocked=k_blocked)
        plan = cuda_backend.LAST_PLAN["cumsum"]
        if k_blocked is None:
            assert not plan["kblocked"] and all(k.window is None
                                                for k in st.backend.program.kernels)
            assert plan["declined"]["kblocked"] == "one pass, the default (k_blocked=True blocks)"
            assert st.backend.source.count("__global__") == 1
        else:
            assert plan["kblocked"]["KB"] == [shape[2] if shape[2] < 512 else 256]
        np.testing.assert_allclose(got["out"].numpy(), ref["out"], rtol=1e-12, atol=0)


def test_parallel_cross_statement_k_dependency_declines(emulated):  # noqa: F811
    """An all-PARALLEL stencil at dK 512 (the JAX test's K-offset read of
    a sibling statement's output): no column loop, so one pass, recorded,
    and equal to the oracle."""
    arrays = dict(inp=_ranges((12, 12, 512), 29), out=np.zeros((12, 12, 512)))
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=two_stmt, rebuild=True)(
        **ref, origin=(0, 0, 0), domain=(12, 12, 512))
    _, got = _run(two_stmt, arrays, (0, 0, 0), (12, 12, 512))
    plan = cuda_backend.LAST_PLAN["two_stmt"]
    assert not plan["kblocked"] and plan["declined"]["kblocked"] == "no loop in the column form"
    np.testing.assert_allclose(got["out"].numpy(), ref["out"], rtol=1e-12, atol=0)


def test_variable_k_declines_as_the_jax_package():
    """Variable K and runtime interval bounds keep the one-pass form even
    with ``k_blocked=True`` (the JAX package's eligibility), and the plan
    names the reason."""
    P = pgts.Field[np.float64]

    def shift(inp: P, idx: pgts.Field[np.int64], out: P):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, idx]

    def runtime(a: P, out: P, *, kmid: int):
        with computation(FORWARD):
            with interval(0, kmid):
                out = a
            with interval(kmid, None):
                out = out[0, 0, -1] + a

    pgts.stencil(backend="cuda", definition=shift, rebuild=True, k_blocked=True)
    assert cuda_backend.LAST_PLAN["shift"]["declined"]["kblocked"] == \
        "a variable or absolute K access"
    st = pgts.stencil(backend="cuda", definition=runtime, rebuild=True, k_blocked=True)
    assert cuda_backend.LAST_PLAN["runtime"]["declined"]["kblocked"] == \
        "a runtime interval bound"
    assert all(k.window is None for k in st.backend.program.kernels)


def test_window_kernel_source():
    """One build serves every block: the window kernel takes the block's
    bounds at launch, stages the read-only inputs and reads them from
    shared memory; the carry stays in device memory."""
    st = pgts.stencil(backend="cuda", definition=to_port(tridiag), rebuild=True, k_blocked=True)
    src = st.backend.source
    assert src.count("__global__") == 4  # two column loops and their K4 variants
    assert "int kb0,\n    int kb1,\n    int KB) {" in src
    assert "w_diag[((k + 0 - kb0) * 2 + (ti + 0)) * 32 + (tj + 0)]" in src
    assert "f_sup.at(i + 0, j + 0, k + -1)" in src  # written: read from device memory
    windows = [k.window for k in st.backend.program.kernels]
    # the backward loop stages the forward loop's outputs, which it only reads
    assert [sorted(a[0] for a in w.arrays) for w in windows] == [["diag", "inf"],
                                                                 ["rhs", "sup"]]
    # two float64 inputs of 2 x 32 columns: 1 KiB a level, 128 levels fit 227 KiB
    assert [w.choose_kb(2048) for w in windows] == [128, 128]
    assert windows[0].choose_kb(100) == 100
