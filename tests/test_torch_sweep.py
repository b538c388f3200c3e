"""K5's sweep form on the emulated kernels, against the JAX package.

A serialized PARALLEL loop and the run of serial loops after it run as one
``<stencil>_k<n>_sweep`` kernel (``sweep=True``; ``serialize=True``
keeps the plane-sweep and fused column kernels): each CTA sweeps K once over its tile, the plane
part ``lead`` levels ahead of the first column loop, which reads what the
plane part wrote from a shared ring; the later loops run after the sweep.
Here the kernels are built by the host compiler against the emulated
runtime of ``tests/test_torch_emulated.py`` and held to the JAX package's
numpy oracle and serialized ``"pallas"`` (interpret mode) at rtol 1e-12 in
float64, and to the split build and the plain executor bit for bit in
float32.  Each form the sweep declines is named in ``LAST_PLAN``.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.models import dycore as p_dycore

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port
from .test_torch_plane import CASES as PLANE_CASES
from .test_torch_plane import _jax as _plane_jax
from .test_torch_plane import _port as _plane_port
from .test_torch_plane import _retyped
from .test_torch_tiles import _arrays as _tile_arrays
from .test_torch_tiles import _jax as _tile_jax
from .test_torch_tiles import _port as _tile_port

F = jgts.Field[np.float64]


def _plane_arrays(defn, shape, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.random(shape) for n in defn.__annotations__}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def ser_mixed(a: F, out: F):
    # tests/cartesian/test_serialize_parallel.py::test_serialize_mixed_stencil
    with computation(PARALLEL), interval(...):
        t = a[1, 0, 0] + a[-1, 0, 0]
    with computation(FORWARD):
        with interval(0, 1):
            acc = t
            out = acc
        with interval(1, None):
            acc = acc[0, 0, -1] + t
            out = acc


def ahead_mixed(a: F, out: F):
    # the first serial loop reads the PARALLEL loop's t a level ahead and a
    # level behind: a ring of three levels
    with computation(PARALLEL), interval(...):
        t = a[0, 1, 0] - a[0, -1, 0]
    with computation(FORWARD):
        with interval(0, 1):
            out = t[0, 0, 1]
        with interval(1, -1):
            out = out[0, 0, -1] * 0.5 + t[0, 0, 1] - t[0, 0, -1]
        with interval(-1, None):
            out = t
    with computation(BACKWARD):
        with interval(0, -1):
            out = out + out[0, 0, 1] * 0.25


#: the mixed stencils: definition, buffer shape, origin, domain
MIXED = {"mixed": PLANE_CASES["mixed"][:4],
         "ser_mixed": (ser_mixed, (14, 12, 7), (2, 2, 0), (10, 8, 7)),
         "ahead_mixed": (ahead_mixed, (14, 37, 6), (2, 2, 0), (10, 33, 6))}


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("name", list(MIXED))
def test_sweep_emulated_vs_oracle_pallas_and_split(emulated, monkeypatch, name,  # noqa: F811
                                                   periodic):
    """Each mixed stencil in the sweep form -- one kernel, counted by its
    library -- equals the JAX package's numpy oracle and its serialized
    Pallas kernel (interpret mode) at rtol 1e-12 in float64, and in float32
    the split build (the default) and plain bit for bit."""
    defn, shape, origin, domain = MIXED[name]
    arrays = _plane_arrays(defn, shape)
    kw = dict(origin=origin, domain=domain, periodic=periodic)
    ref = _plane_jax(defn, "numpy", arrays, **kw)
    monkeypatch.setenv("GT4PY_TPU_PALLAS_SERIALIZE", "1")
    pallas = _plane_jax(defn, "pallas", arrays, **kw) if periodic else ref
    st = pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True, sweep=True)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    st.backend.build()  # the library's count, shared by the builds of one source
    before = st.backend.device_launches()["all"]
    st(**out, **kw)
    plan = cuda_backend.LAST_PLAN[defn.__name__]
    assert plan["forms"] == ["sweep"] and plan["serialized"], plan
    assert st.backend.device_launches()["all"] - before == 1
    written = [n for n, info in st.field_info.items() if info.access.value & 2]
    for k in written:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-12, atol=0, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), pallas[k], rtol=1e-12, atol=0, err_msg=k)
    d32 = _retyped(defn, jgts.Field[np.float32])
    a32 = {k: v.astype(np.float32) for k, v in arrays.items()}
    got = {label: _plane_port(d32, a32, backend=backend, options=options, **kw)[1]
           for label, backend, options in (("sweep", "cuda", {"sweep": True}),
                                           ("split", "cuda", {}), ("plain", "torch", {}))}
    for k in written:
        np.testing.assert_array_equal(got["sweep"][k], got["split"][k], err_msg=k)
        np.testing.assert_array_equal(got["sweep"][k], got["plain"][k], err_msg=k)


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
def test_fused_dycore_sweep_vs_oracle_and_pallas(emulated, periodic):  # noqa: F811
    """The fused MiniDycore stencil in the sweep form (its diffusion one
    level ahead of the tridiagonal solve, ``u_stage`` in a ring of three
    levels, ``ccol`` and ``dcol`` stored for the BACKWARD loop) equals the
    JAX package's numpy oracle and Pallas kernels at rtol 1e-12 in float64,
    one launch a call."""
    arrays = _tile_arrays("dycore_fused", np.float64)
    ref = _tile_jax("dycore_fused", "numpy", arrays, periodic)
    pallas = _tile_jax("dycore_fused", "pallas", arrays, periodic) if periodic else ref
    st, got, counted = _tile_port("dycore_fused", np.float64, arrays, periodic=periodic,
                                  sweep=True)
    plan = cuda_backend.LAST_PLAN[st.name]
    (rec,) = plan["sweep"]
    assert plan["forms"] == ["sweep"] and counted == 1, plan
    assert rec["lead"] == 1 and rec["ring"] == {"u_stage": 3} and rec["staged"] == ["u@k0"]
    assert rec["threads"] == rec["tile"][0] * rec["tile"][1]
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(v, pallas[k], rtol=1e-12, atol=1e-12, err_msg=k)


def offset_read(a: F, out: F):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(FORWARD), interval(...):
        out = t[1, 0, 0]


def variable_k(a: F, idx: jgts.Field[np.int64], out: F):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(FORWARD), interval(...):
        out = t[0, 0, idx]


def far_behind(a: F, out: F):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(FORWARD):
        with interval(0, 8):
            out = t
        with interval(8, None):
            out = t[0, 0, -8] + out[0, 0, -1]


def reads_serial_output(a: F, out: F):
    with computation(PARALLEL), interval(...):
        t = a + out
    with computation(FORWARD), interval(...):
        out = t * 0.5


def opposite(a: F, out: F):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
    with computation(BACKWARD):
        with interval(-1, None):
            out = t
        with interval(0, -1):
            out = t + out[0, 0, 1]


def written_twice(a: F, out: F):
    with computation(PARALLEL), interval(...):
        out = a * 2.0
    with computation(FORWARD), interval(1, None):
        out = out[0, 0, -1] + a


def conditional(a: F, out: F):
    with computation(PARALLEL), interval(...):
        t = a
        if a > 0.5:
            t = a * 2.0
    with computation(FORWARD), interval(...):
        out = t


#: each decline: definition, buffer shape, and what its reason names
DECLINES = {
    "offset_read": (offset_read, (12, 11, 5), "at a horizontal offset"),
    "variable_k": (variable_k, (12, 11, 5), "at a variable K"),
    "far_behind": (far_behind, (12, 11, 12), "a ring of 9 levels"),
    "reads_serial_output": (reads_serial_output, (12, 11, 5),
                            "the PARALLEL loop reads 'out', which a serial loop after it writes"),
    "opposite": (opposite, (12, 11, 5), "runs BACKWARD, the other way"),
    "written_twice": (written_twice, (12, 11, 5),
                      "written by the PARALLEL loop and by a serial loop after it"),
    "conditional": (conditional, (12, 11, 5), "not written by an unconditional statement"),
}


@pytest.mark.parametrize("name", list(DECLINES))
def test_sweep_declines_are_named(emulated, monkeypatch, name):  # noqa: F811
    """Where one sweep cannot order a stencil, the serialized build keeps
    the plane-sweep kernel and the fused column kernel (two launches) and
    names why in ``LAST_PLAN[name]["declined"]["sweep"]``, equal to plain;
    ``serialize=True`` builds the same plan and record, ``sweep=True``
    raises with the same reason."""
    defn, shape, why = DECLINES[name]
    monkeypatch.setattr(cuda_backend, "SERIALIZE_MIXED", True)
    rng = np.random.default_rng(7)
    arrays = {n: rng.random(shape) for n in defn.__annotations__ if n != "idx"}
    if name == "variable_k":
        arrays["idx"] = rng.integers(0, shape[2], shape).astype(np.int64)
    kw = dict(origin=(1, 1, 0), domain=(shape[0] - 2, shape[1] - 2, shape[2]))
    got = {}
    for backend in ("cuda", "torch"):
        got[backend] = _plane_port(defn, arrays, backend=backend, **kw)[1]
        if backend == "cuda":
            plan = cuda_backend.LAST_PLAN[defn.__name__]
            assert why in plan["declined"]["sweep"], plan
            assert plan["serialized"] and "sweep" not in plan["forms"], plan
    for k in got["torch"]:
        np.testing.assert_allclose(got["cuda"][k], got["torch"][k], rtol=1e-12, atol=0, err_msg=k)
    st = pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True, serialize=True)
    assert why in st.backend.program.declined["sweep"]
    assert not any(k.sweep for k in st.backend.program.kernels)
    with pytest.raises(NotImplementedError, match=why.replace("(", r"\(")):
        pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True, sweep=True)


def overlapping(a: F, out: F):
    # at three levels the FORWARD sections cover [0, 2) and [1, 3)
    with computation(PARALLEL), interval(...):
        t = a[1, 0, 0] * 2.0
    with computation(FORWARD):
        with interval(0, 2):
            out = t
        with interval(-2, None):
            out = out[0, 0, -1] + t


def test_overlapping_sections_run_the_plane_and_column_kernels(emulated):  # noqa: F811
    """Where a call's sections of one loop overlap along K, interleaving
    them level by level need not keep their order: that call runs the
    plane-sweep and fused column kernels the sweep replaces (built beside
    it), records why, and equals plain; where they do not, the sweep
    runs."""
    for nk, forms in ((3, ["planes", "column"]), (4, ["sweep"])):
        shape = (12, 11, nk)
        arrays = _plane_arrays(overlapping, shape, seed=nk)
        kw = dict(origin=(1, 1, 0), domain=(10, 9, nk))
        st, got = _plane_port(overlapping, arrays, options={"sweep": True}, **kw)
        plan = cuda_backend.LAST_PLAN["overlapping"]
        assert plan["forms"] == forms and st.backend.launches == 1, plan
        assert (plan["declined"].get("sweep") == cuda_backend.SWEEP_UNORDERED) == (nk == 3), plan
        _, ref = _plane_port(overlapping, arrays, backend="torch", **kw)
        for k in arrays:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_kblocked_runs_the_plane_kernel_and_the_windows(emulated):  # noqa: F811
    """Under K4 (``k_blocked=True``) the sweep build runs the plane-sweep
    kernel and each column loop's K-window kernel, as the plane form does,
    bit for bit with plain; one pass runs the sweep."""
    got = {}
    for backend, options in (("cuda", {"sweep": True, "k_blocked": True}), ("torch", {})):
        st = p_dycore.make_dycore_fused(np.float32, backend, **options)
        m = p_dycore.MiniDycore(12, 10, 20, dtype=np.float32, backend="torch", aligned=False,
                                device="cpu")
        s = m.init_state(seed=3)
        fn = st.functional(origin=(m.oi, m.oj, 0), domain=(12, 10, 20), physical_layout=True)
        got[backend] = fn(u=s["u"], coeff=s["coeff"], wcon=s["wcon"], utens=s["utens"],
                          utens_stage=s["utens_stage"], u_out=torch.zeros_like(s["u"]),
                          dtr_stage=3.0)
        if backend == "cuda":
            plan = cuda_backend.LAST_PLAN[st.name]
            assert plan["kblocked"]["launches_per_loop"] == [1, 1], plan
            assert plan["forms"] == ["sweep"] and plan["serialized"], plan
    for k, v in got["torch"].items():
        assert torch.equal(got["cuda"][k], v), k


def test_plain_form_of_the_sweep_is_the_serialized_stencil(emulated):  # noqa: F811
    """K5's plain counterpart (``testing.plain_form``: the plain executor
    on the serialized stencil) equals the sweep kernel bit for bit."""
    defn, shape, origin, domain = MIXED["ser_mixed"]
    arrays = {k: v.astype(np.float32) for k, v in _plane_arrays(defn, shape).items()}
    d32 = _retyped(defn, jgts.Field[np.float32])
    st, got = _plane_port(d32, arrays, options={"sweep": True}, origin=origin, domain=domain)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    testing.plain_form(st)(**out, origin=origin, domain=domain)
    for k in arrays:
        np.testing.assert_array_equal(got[k], out[k].numpy(), err_msg=k)
