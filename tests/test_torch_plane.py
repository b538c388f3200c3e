"""The plane-sweep form on the emulated kernels, against the JAX package.

The ``"cuda"`` backend runs a serial loop that reads, at a horizontal
offset, a field it writes -- and, serialized (K5), the PARALLEL loops of a
mixed stencil -- as one kernel per loop in which each CTA sweeps K over its
(I, J) tile, its plane-local temporaries in shared memory.  Here the
kernels are built by the host compiler against the emulated runtime of
``tests/test_torch_emulated.py`` (a block's threads as fibers that meet at
every ``__syncthreads()``) and held to the JAX package: its numpy oracle
and ``"pallas"`` in interpret mode (serialized, ``GT4PY_TPU_PALLAS_
SERIALIZE=1``) at rtol 1e-12 in float64, and the port's plain executor bit
for bit in float32.  ``cuda_backend.LAST_PLAN`` must show the form that
ran.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval
from gt4py_tpu.models import dycore as j_dycore

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.models import dycore as p_dycore
from gt4py_tpu_torch.models.dycore import state_from_numpy

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port

F = jgts.Field[np.float64]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def fault1(a: F, b: F):
    with computation(FORWARD), interval(...):
        t = a + 1.0
        b = t[1, 0, 0]


def mixed(a: F, b: F, out: F):
    # tests/cartesian/test_serialize_parallel.py::test_mixed_stencil_parity_serialized
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


def carried(a: F, c: F):
    # a temporary carried in K and read at a horizontal offset in the loop
    # that writes it: the CTA keeps its own ring of the last two planes
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t[1, 0, 0] + t[0, -1, 0]
        with interval(1, None):
            t = t[0, 0, -1] * 0.5 + a
            c = t[1, 0, 0] + t[0, -1, 0]


def backward_carried(a: F, c: F):
    with computation(BACKWARD):
        with interval(-1, None):
            t = a
            c = t[-1, 0, 0] - t[0, 1, 0]
        with interval(0, -1):
            t = t[0, 0, 1] * 0.25 + a
            c = t[-1, 0, 0] - t[0, 1, 0]


def ahead(a: F, c: F):
    # a level the sweep has not reached, at another CTA's points: read from
    # a copy of ``t`` taken before the kernel
    with computation(FORWARD):
        with interval(0, -1):
            t = a + 1.0
            c = t[1, 0, 1] + t
        with interval(-1, None):
            t = a
            c = t


def ahead_backward(a: F, c: F):
    with computation(BACKWARD):
        with interval(1, None):
            t = a * 2.0
            c = t[0, -1, -1] - t
        with interval(0, 1):
            t = a
            c = t


def before_write(a: F, c: F):
    # the plane's own level at another CTA's points before the plane writes
    # it: the value from before the loop, from the copy too
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, 0] + t[0, -1, 0]
            t = a * 2.0


def ring(a: F, c: F):
    # an earlier level read at the neighbour's point, before the plane's
    # writer, which the extent analysis leaves at the tile's own points: the
    # writer is widened so that each CTA computes its ring there itself
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, -1]
            t = a * 2.0


def runtime_bound(a: F, out: F, *, kmid: int):
    # serialize_parallel_k declines a runtime interval bound
    with computation(PARALLEL):
        with interval(0, kmid):
            t = a[1, 0, 0] * 2.0
        with interval(kmid, None):
            t = a[-1, 0, 0] * 3.0
    with computation(FORWARD):
        with interval(0, 1):
            out = t
        with interval(1, None):
            out = out[0, 0, -1] + t


CASES = {
    # name: (definition, buffer shape, origin, domain, scalars)
    "fault1": (fault1, (12, 10, 6), (1, 1, 0), (10, 8, 6), {}),
    "mixed": (mixed, (16, 14, 9), (4, 4, 1), (8, 6, 7), {}),
    "carried": (carried, (12, 11, 6), (1, 1, 0), (10, 9, 6), {}),
    "backward_carried": (backward_carried, (13, 11, 6), (2, 1, 0), (10, 9, 5), {}),
    "ahead": (ahead, (12, 10, 6), (1, 1, 0), (10, 8, 6), {}),
    "ahead_backward": (ahead_backward, (12, 11, 6), (1, 2, 0), (10, 8, 6), {}),
    "before_write": (before_write, (12, 11, 6), (1, 1, 0), (10, 9, 6), {}),
    # two tiles on each axis, so the widened points lie in another CTA's tile
    "ring": (ring, (23, 36, 5), (1, 1, 0), (20, 34, 5), {}),
}


def _arrays(defn, shape, seed=0):
    names = list(defn.__annotations__)
    rng = np.random.default_rng(seed)
    return {n: rng.random(shape) for n in names if defn.__annotations__[n] is F}


def _written(st):
    return [n for n, info in st.field_info.items() if info.access.value & 2]


def _jax(defn, backend, arrays, **kw):
    st = jgts.stencil(backend=backend, definition=defn, rebuild=True)
    out = {k: v.copy() for k, v in arrays.items()}
    st(**out, **kw)
    return out


def _port(defn, arrays, backend="cuda", **kw):
    options = kw.pop("options", {})
    st = pgts.stencil(backend=backend, definition=to_port(defn), rebuild=True, **options)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    st(**out, **kw)
    return st, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("name", list(CASES))
def test_plane_form_emulated_vs_oracle_and_pallas(emulated, monkeypatch, name, periodic):  # noqa: F811
    """Fault 1's stencil (a FORWARD loop reading ``t[1, 0, 0]`` of the ``t``
    it writes), the mixed stencil of ``test_serialize_parallel.py`` and the
    K-carried temporaries read at offsets: the plane-sweep kernels equal the
    JAX package's numpy oracle and its serialized Pallas kernel (interpret
    mode) at rtol 1e-12.  The mixed stencil runs serialized both ways: its
    PARALLEL loop's plane kernel and the fused column kernel
    (``serialize=True``), and the sweep form (``sweep=True``,
    one kernel)."""
    defn, shape, origin, domain, scalars = CASES[name]
    arrays = _arrays(defn, shape)
    kw = dict(origin=origin, domain=domain, periodic=periodic, **scalars)
    ref = _jax(defn, "numpy", arrays, **kw)
    monkeypatch.setenv("GT4PY_TPU_PALLAS_SERIALIZE", "1")
    pallas = _jax(defn, "pallas", arrays, **kw)
    mixed = name == "mixed"
    runs = ({"serialize": True}, {"sweep": True}) if mixed else ({},)
    for options in runs:
        st, got = _port(defn, arrays, options=options, **kw)
        plan = cuda_backend.LAST_PLAN[defn.__name__]
        form = "sweep" if options.get("sweep") else "planes"
        assert form in plan["forms"] and st.backend.launches == 1, plan
        assert plan["serialized"] == mixed, plan
        if options.get("serialize"):
            assert plan["declined"]["sweep"] == cuda_backend.SWEEP_OPT_IN, plan
        assert plan["widened"] == ({"t": [[0, 1], [0, 0]]} if name == "ring" else {}), plan
        # the JAX package fills a periodic input's halos in place; the port
        # in a copy: the written fields are the result
        for k in _written(st):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=0, err_msg=k)
            np.testing.assert_allclose(got[k], pallas[k], rtol=1e-12, atol=0, err_msg=k)


def test_plane_plans_record_where_values_live():
    """The plan record: fault 1's ``t`` in one shared plane (no scratch);
    the carried ``t`` mirrored with a ring of two planes, in scratch too."""
    pgts.stencil(backend="cuda", definition=to_port(fault1), rebuild=True)
    plan = cuda_backend.LAST_PLAN["fault1"]
    assert plan["forms"] == ["planes"] and plan["shared"] == ["t"] and plan["scratch"] == []
    assert plan["tile"] == [16, 32]
    st = pgts.stencil(backend="cuda", definition=to_port(carried), rebuild=True)
    (k,) = st.backend.program.kernels
    assert k.planes.mirrored == {"t": 2} and st.backend.program.scratch == ["t"]
    assert "gt::slot(k + -1, 2)" in st.backend.source


#: the mixed stencils' builds and the forms each runs (``LAST_PLAN``)
MIXED_FORMS = {"sweep": ({"sweep": True}, ["sweep"]),
               "planes": ({"serialize": True}, ["planes", "column"]),
               "split": ({}, ["tile", "column"])}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_mixed_forms_agree_bit_for_bit(emulated, dtype):  # noqa: F811
    """The mixed stencil serialized -- in the sweep form (one kernel, K5)
    and in the plane-sweep form with the fused column kernel -- and split
    (the default: tile and column kernels) on the emulated kernels, the
    plain executor on the serialized stencil (``testing.plain_form``) and
    on the original one: bit for bit."""
    defn, shape, origin, domain, _ = CASES["mixed"]
    arrays = {k: v.astype(dtype) for k, v in _arrays(defn, shape, seed=3).items()}
    if dtype == np.float32:
        defn = _retyped(defn, jgts.Field[np.float32])
    got = {}
    for label, (options, forms) in list(MIXED_FORMS.items()) + [("plain", ({}, None))]:
        backend = "torch" if label == "plain" else "cuda"
        st, got[label] = _port(defn, arrays, backend=backend, options=options,
                               origin=origin, domain=domain, periodic=("I", "J"))
        if backend == "cuda":
            assert cuda_backend.LAST_PLAN[defn.__name__]["forms"] == forms, label
        if label == "sweep":
            # K5's plain counterpart: the plain executor on the serialized stencil
            ser = testing.plain_form(st)
            out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
            ser(**out, origin=origin, domain=domain, periodic=("I", "J"))
            got["serialized plain"] = {k: v.numpy() for k, v in out.items()}
    for k in arrays:
        for label in list(MIXED_FORMS) + ["serialized plain"]:
            np.testing.assert_array_equal(got[label][k], got["plain"][k], err_msg=f"{label} {k}")


def _retyped(defn, field):
    import types

    new = types.FunctionType(defn.__code__, defn.__globals__, defn.__name__)
    new.__annotations__ = {k: field for k in defn.__annotations__}
    return new


def test_serialization_declined_is_recorded(emulated, monkeypatch):  # noqa: F811
    """A mixed stencil runs split by default and records why
    (``SPLIT_MIXED``); where the default serializes mixed stencils
    (``SERIALIZE_MIXED``), one that ``serialize_parallel_k`` declines (a
    runtime interval bound) keeps the split plan and records why; both
    equal the oracle; ``serialize=True`` and ``sweep=True`` raise
    instead."""
    defn = runtime_bound
    arrays = _arrays(defn, (10, 10, 6))
    kw = dict(origin=(1, 1, 0), domain=(8, 8, 6), kmid=3)
    ref = _jax(defn, "numpy", arrays, **kw)
    for serialize_mixed, why in ((False, cuda_backend.SPLIT_MIXED),
                                 (True, "serialize_parallel_k declined")):
        monkeypatch.setattr(cuda_backend, "SERIALIZE_MIXED", serialize_mixed)
        st, got = _port(defn, arrays, **kw)
        plan = cuda_backend.LAST_PLAN["runtime_bound"]
        assert not plan["serialized"] and "planes" not in plan["forms"]
        assert why in plan["declined"]["serialize"], plan
        for k in arrays:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=0, err_msg=k)
    for option in ("serialize", "sweep"):
        with pytest.raises(NotImplementedError, match="serialize_parallel_k declined"):
            pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True,
                         **{option: True})


def test_read_ahead_reads_a_snapshot():
    """A read, at another CTA's points, of a value the sweep has not
    written yet (a later level, or the plane's own level before its write)
    takes the value from before the loop: a copy of ``t`` made just before
    the kernel (the parity test above runs both)."""
    st = pgts.stencil(backend="cuda", definition=to_port(ahead), rebuild=True)
    assert cuda_backend.LAST_PLAN["ahead"]["snapshots"] == ["t"]
    src = st.backend.source
    assert "o_t.at(i + 1, j + 0, k + 1)" in src and "t_t.at(i + 0, j + 0, k + 0)" in src
    assert src.index("ahead_snap_t<<<") < src.index("ahead_k0<<<")
    src = pgts.stencil(backend="cuda", definition=to_port(before_write),
                       rebuild=True).backend.source
    assert "o_t.at(i + 1, j + 0, k + 0)" in src and "o_t.at(i + 0, j + -1, k + 0)" in src


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
def test_fused_dycore_forms_vs_plain_and_oracle(emulated, periodic):  # noqa: F811
    """``MiniDycore.step_fn(fused=True)`` at 16x16x8: the sweep form
    (``sweep=True``, one kernel a call), the plane-sweep form
    (``serialize=True``), the split build (the default) and
    the plain executor agree bit for bit over three float32 steps; in
    float64 the sweep form equals the JAX model (its XLA executor) at rtol
    1e-12."""
    got = {}
    for label, (options, forms) in list(MIXED_FORMS.items()) + [("plain", ({}, None))]:
        backend = "torch" if label == "plain" else "cuda"
        m = p_dycore.MiniDycore(16, 16, 8, dtype=np.float32, backend=backend, aligned=False,
                                device="cpu", options=options)
        state = m.init_state(seed=2)
        step = m.step_fn(fused=True, fill_halos=periodic)
        if backend == "cuda":
            m.fused.backend.build()  # the count belongs to the library of its source
        before = m.fused.backend.device_launches()["all"] if backend == "cuda" else 0
        for _ in range(3):
            state = step(state)
        got[label] = state
        if backend == "cuda":
            plan = cuda_backend.LAST_PLAN["dycore_fused_float32"]
            assert plan["forms"] == forms and plan["serialized"] == (label != "split"), plan
            counted = m.fused.backend.device_launches()["all"] - before
            assert counted == 3 * len(forms), (label, counted)
    for k in ("u", "utens_stage"):
        for label in MIXED_FORMS:
            assert torch.equal(got[label][k], got["plain"][k]), (label, k)

    jm = j_dycore.MiniDycore(16, 16, 8, dtype=np.float64, backend="jax", aligned=False)
    jstate = jm.init_state(seed=2)
    pm = p_dycore.MiniDycore(16, 16, 8, dtype=np.float64, backend="cuda", aligned=False,
                             device="cpu", options={"sweep": True})
    pstate = state_from_numpy(jstate, "cpu")
    jout = jm.step_fn(fused=True, fill_halos=periodic)(
        {k: jnp.asarray(v) for k, v in jstate.items()})
    pout = pm.step_fn(fused=True, fill_halos=periodic)(pstate)
    assert cuda_backend.LAST_PLAN["dycore_fused_float64"]["forms"] == ["sweep"]
    for k in ("u", "utens_stage"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=1e-12, atol=0,
                                   err_msg=k)


def test_serialize_true_runs_an_all_parallel_stencil_in_planes(emulated):  # noqa: F811
    """``serialize=True`` serializes a stencil with only PARALLEL loops too:
    hdiff in one plane-sweep kernel, bit for bit with the plain executor."""
    got = {}
    for label, backend, options in (("planes", "cuda", {"serialize": True}),
                                    ("plain", "torch", {})):
        st = p_dycore.make_hdiff(np.float32, backend, **options)
        m = p_dycore.MiniDycore(12, 20, 4, dtype=np.float32, backend="torch", aligned=False,
                                device="cpu")
        s = m.init_state(seed=1)
        fn = st.functional(origin=(m.oi, m.oj, 0), domain=(12, 20, 4), physical_layout=True,
                           periodic=("I", "J"))
        got[label] = fn(in_field=s["u"], out_field=s["u"], coeff=s["coeff"])["out_field"]
        if backend == "cuda":
            assert [k.form for k in st.backend.program.kernels] == ["planes"]
    assert torch.equal(got["planes"], got["plain"])
