"""Variable and absolute K (K3) on the emulated kernels, against the JAX
package.

A row-form stage that reads a field at a variable K runs in the staged
form: a CTA of columns marches the stage's levels, the gathered field's
levels for its columns in a shared-memory window (the whole buffer column,
or a ring of levels around the step when the column does not fit), the read
an indexed shared-memory load at its clipped level, and a level outside the
window a device-memory load that the kernel counts.  A read at an absolute
K whose index does not vary along K is loaded once before the K loop, in
every form.  Here the kernels are built by the host compiler against the
emulated runtime of ``tests/test_torch_emulated.py`` (its fibers meet at
every ``__syncthreads()``, ``gt::async_copy`` is a synchronous copy) and
held to the JAX package -- its numpy oracle and ``"pallas"`` (interpret
mode) at rtol 1e-12 / atol 1e-12 in float64 -- and, in float32, to the
port's plain executor and its ``stage_vark=False`` build bit for bit.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


I64 = jgts.Field[np.int64]
IJ64 = jgts.Field[jgts.IJ, np.int64]
TOL = dict(rtol=1e-12, atol=1e-12)


def _definitions(dtype):
    """The cases' definitions with fields of ``dtype``."""
    F = jgts.Field[dtype]

    def variable_k_offset(inp: F, idx: I64, out: F):
        with computation(PARALLEL), interval(...):
            out = inp[0, 0, idx]

    def variable_k_and_offset(inp: F, idx: I64, out: F):
        with computation(PARALLEL), interval(...):
            out = inp[0, 0, idx] + inp[1, 0, 0] - inp[0, -1, 0]

    def variable_k_after_write(a: F, kidx: I64, out: F):
        with computation(PARALLEL), interval(1, None):
            t = a * 2.0
        with computation(PARALLEL), interval(...):
            out = t[0, 0, kidx] + t[1, 0, 0]

    def at_k_literal(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a.at(K=2) + a[0, 0, 0]

    def at_k_scalar(a: F, out: F, *, kidx: int):
        with computation(PARALLEL), interval(...):
            out = a.at(K=kidx)

    def at_k_field(a: F, kidx: IJ64, out: F):
        with computation(PARALLEL), interval(...):
            out = a.at(K=kidx) * 2.0

    def at_k_in_scan(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a.at(K=3)
            with interval(1, None):
                out = a.at(K=0) + out[0, 0, -1]

    def variable_k_in_scan(a: F, kidx: I64, acc: F):
        with computation(BACKWARD), interval(...):
            acc = a[0, 0, kidx] + acc[0, 0, 1] * 0.5

    return {d.__name__: d for d in (
        variable_k_offset, variable_k_and_offset, variable_k_after_write, at_k_literal,
        at_k_scalar, at_k_field, at_k_in_scan, variable_k_in_scan)}


DEFS = {np.dtype(dt): _definitions(dt) for dt in (np.float64, np.float32)}
F64 = jgts.Field[np.float64]
globals().update(DEFS[np.dtype(np.float64)])


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape)


def _ints(seed, lo, hi, shape):
    return np.random.default_rng(seed).integers(lo, hi + 1, shape).astype(np.int64)


#: (I, J, K) buffers: two J tiles (the second partial), three I tiles,
#: levels that leave a partial step
SHAPE = (5, 40, 9)

#: name -> (definition, inputs(dtype), call keywords, the staged form runs)
CASES = {
    "narrow": ("variable_k_offset", lambda dt: dict(
        inp=_rand(1, SHAPE).astype(dt), idx=_ints(2, -3, 3, SHAPE),
        out=np.zeros(SHAPE, dt)), {}, True),
    "whole_column": ("variable_k_offset", lambda dt: dict(
        inp=_rand(3, SHAPE).astype(dt), idx=_ints(4, -9, 9, SHAPE),
        out=np.zeros(SHAPE, dt)), {}, True),
    "clamped": ("variable_k_offset", lambda dt: dict(
        inp=_rand(5, SHAPE).astype(dt),
        idx=np.where(_ints(6, 0, 1, SHAPE) == 1, 14, -14) + _ints(7, -2, 2, SHAPE),
        out=np.zeros(SHAPE, dt)), {}, True),
    # a nonzero K origin: the buffer holds two levels below the domain,
    # where the clipped reads reach too
    "k_origin": ("variable_k_offset", lambda dt: dict(
        inp=_rand(8, (5, 40, 11)).astype(dt), idx=_ints(9, -12, 12, (5, 40, 11)),
        out=np.zeros((5, 40, 11), dt)), dict(origin=(0, 0, 2), domain=(5, 40, 8)), True),
    "offsets_periodic": ("variable_k_and_offset", lambda dt: dict(
        inp=_rand(10, (7, 42, 9)).astype(dt), idx=_ints(11, -4, 4, (7, 42, 9)),
        out=np.zeros((7, 42, 9), dt)),
        dict(origin=(1, 1, 0), domain=(5, 40, 9), periodic=("I", "J")), True),
    "after_write": ("variable_k_after_write", lambda dt: dict(
        a=_rand(12, (9, 6, 8)).astype(dt), kidx=_ints(13, -3, 3, (9, 6, 8)),
        out=np.zeros((9, 6, 8), dt)), dict(domain=(8, 6, 8)), False),
    "at_k_literal": ("at_k_literal", lambda dt: dict(
        a=_rand(14, (6, 35, 7)).astype(dt), out=np.zeros((6, 35, 7), dt)), {}, False),
    "at_k_scalar": ("at_k_scalar", lambda dt: dict(
        a=_rand(15, (6, 35, 7)).astype(dt), out=np.zeros((6, 35, 7), dt), kidx=9), {}, False),
    "at_k_field": ("at_k_field", lambda dt: dict(
        a=_rand(16, (6, 35, 7)).astype(dt), kidx=_ints(17, -2, 8, (6, 35)),
        out=np.zeros((6, 35, 7), dt)), {}, False),
    "at_k_in_scan": ("at_k_in_scan", lambda dt: dict(
        a=_rand(18, (7, 9, 8)).astype(dt), out=np.zeros((7, 9, 8), dt)), {}, False),
    "variable_k_in_scan": ("variable_k_in_scan", lambda dt: dict(
        a=_rand(19, (6, 7, 10)).astype(dt), kidx=_ints(20, -9, 9, (6, 7, 10)),
        acc=np.zeros((6, 7, 10), dt)), dict(domain=(6, 7, 9)), False),
}
#: the cases Pallas (interpret mode, seconds a call) also runs
PALLAS = ("narrow", "clamped", "at_k_field", "variable_k_in_scan")


def _split(inputs):
    fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    return fields, {k: v for k, v in inputs.items() if k not in fields}


def _jax(name, backend):
    d, inputs, kw, _ = CASES[name]
    fields, scalars = _split(inputs(np.float64))
    st = jgts.stencil(backend=backend, definition=DEFS[np.dtype(np.float64)][d], rebuild=True)
    st(**fields, **scalars, **kw)
    return fields


def _kij(a):
    """A (K, I, J) buffer viewed as (I, J, K): J contiguous, as the models
    lay out their fields."""
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 2, 0)))
    return t.movedim(0, 2) if a.ndim == 3 else t


def _port(name, dtype, backend="cuda", kij=True, **options):
    """The case on the port: its fields after the call, the stencil, and
    the kernel launches its library counted."""
    d, inputs, kw, _ = CASES[name]
    fields, scalars = _split(inputs(dtype))
    st = pgts.stencil(backend=backend, definition=to_port(DEFS[np.dtype(dtype)][d]),
                      rebuild=True, **options)
    tensors = {k: _kij(v) if kij and v.ndim == 3 else torch.from_numpy(v.copy())
               for k, v in fields.items()}
    if backend == "cuda":
        st.backend.build()  # the library's count reads 0 before its first build
    before = st.backend.device_launches()["all"] if backend == "cuda" else 0
    st(**tensors, **scalars, **kw)
    counted = st.backend.device_launches()["all"] - before if backend == "cuda" else 0
    return {k: v.numpy() for k, v in tensors.items()}, st, counted


@pytest.mark.parametrize("name", list(CASES))
def test_k3_emulated_vs_oracle_and_pallas(emulated, name):  # noqa: F811
    """Each case on the emulated kernels equals the JAX package's numpy
    oracle (and, where listed, its Pallas kernels in interpret mode) at
    rtol 1e-12 in float64, one library-counted launch a kernel; the staged
    form runs where a stage reads at a variable K a field the stencil only
    reads, and its whole-column windows leave no read outside."""
    ref = _jax(name, "numpy")
    pallas = _jax(name, "pallas") if name in PALLAS else ref
    got, st, counted = _port(name, np.float64)
    plan = cuda_backend.LAST_PLAN[st.name]
    assert counted == len(plan["forms"]), (counted, plan)
    if CASES[name][3]:
        assert plan["forms"] == ["vark"], plan
        (rec,) = plan["vark"]
        nk = CASES[name][1](np.float64)["inp"].shape[2]
        assert rec["levels"] == {"inp": nk} and rec["whole"] == {"inp": True}, rec
        assert st.backend.outside_reads() == {rec["kernel"]: 0}
        assert rec["outside"] == 0
    else:
        assert "vark" not in plan["forms"], plan
    for k in ref:
        if st.field_info[k].access.value & 2:  # the oracle fills read-only halos
            np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)
            np.testing.assert_allclose(got[k], pallas[k], **TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_k3_float32_bitwise_vs_plain_and_parent(emulated, name):  # noqa: F811
    """float32: the new kernels equal the plain executor and the
    ``stage_vark=False`` build (the row kernels' device-memory loads) bit
    for bit, in the models' (K, I, J) layout with rows of an odd pitch
    where they have one (their rows start on every 16-byte phase) and in
    the (I, J, K) layout (J not contiguous: element copies)."""
    for kij in (True, False):
        got, st, _ = _port(name, np.float32, kij=kij)
        parent, pst, _ = _port(name, np.float32, kij=kij, stage_vark=False)
        plain, _, _ = _port(name, np.float32, backend="torch", kij=kij)
        assert "vark" not in cuda_backend.LAST_PLAN[pst.name]["forms"]
        for k in plain:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
            np.testing.assert_array_equal(parent[k], plain[k], err_msg=k)


def test_tight_rows_take_sixteen_byte_copies_at_every_phase(emulated):  # noqa: F811
    """A (K, I, J) buffer with rows of 37 float64 (296 bytes: rows start on
    both 16-byte phases) and levels of 185: the window rows are staged
    from their aligned-down words with 16-byte copies; the result equals
    plain bit for bit."""
    shape = (5, 37, 9)
    inp, idx = _rand(21, shape), _ints(22, -9, 9, shape)
    got = {}
    for backend in ("cuda", "torch"):
        st = pgts.stencil(backend=backend, definition=to_port(variable_k_offset), rebuild=True)
        t = {"inp": _kij(inp), "idx": _kij(idx), "out": _kij(np.zeros(shape))}
        if backend == "cuda":
            count = st.backend.build().gt_emu_copies16_count
            before = count()
        st(**t)
        if backend == "cuda":
            assert count() - before > 0
        got[backend] = t["out"]
    assert torch.equal(got["cuda"], got["torch"])


def test_ring_smaller_than_the_reach_counts_reads_outside(emulated, monkeypatch):  # noqa: F811
    """With the window budget cut so that 20 levels do not fit, the window
    is a ring of ``VK_MIN_RING`` levels around each step; reads that reach
    past it load from device memory and the kernel counts them.  The
    result equals the oracle, plain and the whole-column build."""
    shape = (5, 40, 20)
    TI, TJ = cuda_backend.VK_TILE  # float64 rows of TJ + 1 elements, whole words
    monkeypatch.setattr(cuda_backend, "VK_BUDGET",
                        cuda_backend.VK_MIN_RING * TI * (TJ + 2) * 8)
    d = variable_k_offset
    inp, idx = _rand(23, shape), _ints(24, -20, 20, shape)
    ref = {"inp": inp.copy(), "idx": idx, "out": np.zeros(shape)}
    jgts.stencil(backend="numpy", definition=d, rebuild=True)(**ref)
    got = {}
    for label, backend in (("ring", "cuda"), ("plain", "torch")):
        st = pgts.stencil(backend=backend, definition=to_port(d), rebuild=True)
        t = {"inp": _kij(inp), "idx": _kij(idx), "out": _kij(np.zeros(shape))}
        st(**t)
        got[label] = t["out"].numpy()
        if backend == "cuda":
            (rec,) = cuda_backend.LAST_PLAN[st.name]["vark"]
            assert rec["levels"] == {"inp": cuda_backend.VK_MIN_RING}
            assert rec["whole"] == {"inp": False}
            outside = st.backend.outside_reads()[rec["kernel"]]
            assert 0 < outside < np.prod(shape) and rec["outside"] == outside
    monkeypatch.undo()
    np.testing.assert_allclose(got["ring"], ref["out"], **TOL)
    np.testing.assert_array_equal(got["ring"], got["plain"])


def test_written_fields_are_never_staged_or_hoisted(emulated):  # noqa: F811
    """``t``, which an earlier section writes, is read at a variable K from
    device memory (its sections stay two launches, the second not staged:
    ``declined["vark"]`` names it); a field a kernel writes keeps its
    absolute-K reads in the K loop, where they see the writes."""
    st = pgts.stencil(backend="cuda", definition=to_port(variable_k_after_write), rebuild=True)
    prog = st.backend.program
    assert [k.form for k in prog.kernels] == ["rows", "rows"]
    assert "'t' is written by the stencil" in prog.declined["vark"]

    def carry(a: F64, out: F64):
        with computation(FORWARD):
            with interval(0, 1):
                a = a * 3.0
            with interval(1, None):
                out = a.at(K=0) + a
                a = out * 0.5

    src = pgts.stencil(backend="cuda", definition=to_port(carry), rebuild=True).backend.source
    assert "hk0_" not in src
    body = src[src.index("_col("):]
    assert body.index("f_a.kclamp(") > body.index("for (int k")
    shape = (4, 6, 7)
    ref = {"a": _rand(25, shape), "out": np.zeros(shape)}
    fields = {k: torch.from_numpy(v.copy()) for k, v in ref.items()}
    jgts.stencil(backend="numpy", definition=carry, rebuild=True)(**ref)
    pgts.stencil(backend="cuda", definition=to_port(carry), rebuild=True)(**fields)
    for k in ref:
        np.testing.assert_allclose(fields[k].numpy(), ref[k], **TOL, err_msg=k)


def _before_k_loop(src: str, kernel: str, load: str) -> bool:
    """``load`` appears in kernel ``kernel`` before its first K loop and
    not after it."""
    body = src[src.index(f" {kernel}("):]
    body = body[:body.index("\n}\n")]
    loop = body.index("for (int k")
    return load in body[:loop] and load not in body[loop:]


def _plane_at_k(a: F64, b: F64):
    with computation(FORWARD), interval(...):
        t = a.at(K=2) + 1.0
        b = t[1, 0, 0] + a.at(K=2)


@pytest.mark.parametrize("form", ["rows", "vector", "tile", "column", "planes", "vark"])
def test_k_invariant_absolute_reads_load_before_the_k_loop(form):
    """A read at an absolute K whose index does not vary along K (a
    literal, a scalar, a 2-D field) is emitted once, before the kernel's K
    loop: into a register (row, vector row -- one a lane --, fused column
    and staged forms) or a shared plane (tile and plane-sweep forms)."""
    def mixed(a: F64, idx: I64, kidx: IJ64, out: F64):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, idx] + a.at(K=kidx)

    defs = {"rows": (at_k_field, {}), "vector": (at_k_field, {}),
            "tile": (at_k_field, {"tiles": True}), "column": (at_k_in_scan, {}),
            "planes": (_plane_at_k, {}), "vark": (mixed, {})}
    d, options = defs[form]
    st = pgts.stencil(backend="cuda", definition=to_port(d), rebuild=True, **options)
    prog, src = st.backend.program, st.backend.source
    kern = next(k for k in prog.kernels if k.form == {"vector": "rows"}.get(form, form))
    name = kern.name + ("_v" if form == "vector" else "")
    load = {"rows": "f_a.kclamp(f_kidx.at(i + 0, j + 0, 0))",
            "vector": "f_a.kclamp(f_kidx.at(i + 0, j + 0, 0))",
            "tile": "f_a.kclamp(f_kidx.at(i + 0, j + 0, 0))",
            "column": "f_a.kclamp(((long long)3LL))",
            "planes": "f_a.kclamp(((long long)2LL))",
            "vark": "f_a.kclamp(f_kidx.at(i + 0, j + 0, 0))"}[form]
    assert _before_k_loop(src, name, load), name
    if form in ("tile", "planes"):
        assert "hp0_[" in src and cuda_backend.LAST_PLAN[st.name]["forms"] == [form]


def test_stage_vark_option_forces_and_declines():
    """``stage_vark=True`` runs a section that reads at a variable K as
    row stages in the staged form, or raises where none can run;
    ``stage_vark=False`` keeps the row kernels and records why; a
    multi-stage section runs the tile form by default and records that its
    variable-K reads stay in device memory."""
    def two_stage(inp: F64, idx: I64, out: F64):
        with computation(PARALLEL), interval(...):
            t = inp[0, 0, idx] * 2.0
            out = t[1, 0, 0] + t[-1, 0, 0]

    prog = pgts.stencil(backend="cuda", definition=to_port(two_stage),
                        rebuild=True).backend.program
    assert [k.form for k in prog.kernels] == ["tile"]
    assert prog.declined["vark"] == cuda_backend.VARK_IN_TILE
    prog = pgts.stencil(backend="cuda", definition=to_port(two_stage), rebuild=True,
                        stage_vark=True).backend.program
    assert [k.form for k in prog.kernels] == ["vark", "rows"]
    prog = pgts.stencil(backend="cuda", definition=to_port(variable_k_offset), rebuild=True,
                        stage_vark=False).backend.program
    assert [k.form for k in prog.kernels] == ["rows"] and prog.declined["vark"] == \
        "stage_vark=False"
    for d in (variable_k_after_write, at_k_field):
        with pytest.raises(NotImplementedError, match="stage_vark=True"):
            pgts.stencil(backend="cuda", definition=to_port(d), rebuild=True, stage_vark=True)


def test_window_slots_follow_the_budget():
    """The whole column where every window fits ``VK_BUDGET``; else one
    ring depth, the most the budget holds and at least ``VK_MIN_RING``."""
    TI, TJ = cuda_backend.VK_TILE
    vp = cuda_backend.VarkPlan(tile=(TI, TJ), lanes=cuda_backend.VK_LANES,
                               fields=[("a", TJ + 2, 2, 8)])
    per = vp.level_bytes(0)
    assert per == TI * (TJ + 2) * 8
    assert cuda_backend._vark_slots(vp, [80]) == [80]
    deep = cuda_backend.VK_BUDGET // per + 1
    assert cuda_backend._vark_slots(vp, [deep]) == [cuda_backend.VK_BUDGET // per]
    assert vp.window_bytes([80]) <= cuda_backend.VK_BUDGET
    assert cuda_backend.ctas_per_sm(vp.window_bytes([80]), TI * TJ * vp.lanes) >= \
        cuda_backend.VK_CTAS_PER_SM
