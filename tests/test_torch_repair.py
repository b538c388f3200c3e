"""K6 on the emulated kernels: the vector row form and the geometry repair.

The ``"cuda"`` backend's row stages have a vector kernel that computes V
consecutive J points a thread with 16-byte loads and stores; it runs where
every J-contiguous field shares one 16-byte phase with row and level
pitches that are whole words, and a non-periodic call whose fields do not
is repaired (``cartesian/backend/repair.py``: copies in each field's read
window at a common phase, runs, copies each written field's write window
back).  Here the kernels are built by the host compiler against the
emulated runtime of ``tests/test_torch_emulated.py``, whose vector accesses
fault on a misaligned address, and held on the shapes of
``tests/cartesian/test_geometry_repair.py``:

- against the JAX package's ``"pallas"`` under ``ASSUME_TPU_PLANNING``
  (interpret mode, its repair path) at rtol 2e-6 / atol 2e-7 in float32
  (XLA's fused multiply-adds: a few float32 ulps);
- against its numpy oracle at rtol 1e-12 in float64 (the host's ``sin``
  and ``exp`` differ from numpy's by an ulp);
- against the port's plain executor bit for bit in both,

each in the JAX tests' layout (numpy (I, J, K) arrays, J not contiguous:
repaired) and in the models' (K, I, J) layout.
"""

import types

import numpy as np
import pytest
import torch

from gt4py_tpu import config as jconfig
from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.backend import pallas_backend as pb
from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, I, J, computation, horizontal, \
    interval, region

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend, repair
from gt4py_tpu_torch.models import dycore as p_dycore

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port

F = jgts.Field[np.float32]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


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


def wl(a: F, b: F):
    with computation(PARALLEL), interval(...):
        x = a
        while x < 1.0:
            x = x * 2.0 + 0.1
        b = x


def bc(a: F, b: F):
    with computation(PARALLEL), interval(...):
        b = a
        with horizontal(region[I[-1] - 1:, :]):
            b = a + 1.0
        with horizontal(region[: I[0] + 1, J[-1] - 2:]):
            b = a - 2.0


def lap(a: F, b: F):
    with computation(PARALLEL), interval(...):
        b = a[1, 0, 0] + a[-1, 0, 0] - 2.0 * a


def lapj(a: F, b: F):
    with computation(PARALLEL), interval(...):
        b = a[0, 1, 0] + a[0, -1, 0] - 2.0 * a


#: test_geometry_repair.py's cases: definition, {field: (shape, seed)},
#: origins, domain, whether the JAX package's plan repairs
CASES = {
    "outop": (outop, {"inp": ((16, 256, 4), 0), "coeff": ((16, 256, 4), 1),
                      "fx": ((17, 256, 4), 2), "fy": ((16, 257, 4), 3),
                      "res": ((16, 256, 4), None)},
              {"inp": (0, 0, 0), "coeff": (0, 0, 0), "fx": (1, 0, 0), "fy": (0, 1, 0),
               "res": (0, 0, 0)}, (16, 256, 4), True),
    "lapd": (lapd, {"a": ((12, 132, 4), 4), "b": ((14, 140, 4), 5)},
             {"a": (1, 1, 0), "b": (2, 3, 0)}, (10, 130, 4), True),
    "serk": (serk, {"a": ((10, 130, 5), 6), "b": ((10, 130, 5), 7)},
             {"a": (0, 0, 0), "b": (0, 0, 0)}, (10, 130, 5), True),
    "while": (wl, {"a": ((10, 130, 4), 8), "b": ((10, 130, 4), 9)},
              {"a": (0, 0, 0), "b": (0, 0, 0)}, (10, 130, 4), False),
    "region": (bc, {"a": ((33, 228, 2), 11), "b": ((33, 228, 2), 12)},
               {"a": (0, 0, 0), "b": (0, 0, 0)}, (33, 228, 2), True),
    "aligned": (lap, {"a": ((32, 256, 4), 10), "b": ((16, 256, 4), None)},
                {"a": (8, 0, 0), "b": (0, 0, 0)}, (16, 256, 4), False),
    "j_row": (lapj, {"a": ((16, 640, 4), 20), "b": ((16, 640, 4), None)},
              {"a": (0, 128, 0), "b": (0, 128, 0)}, (16, 256, 4), False),
}


#: the fields the port's repair copies in the (K, I, J) layout, by case and
#: item size (in the (I, J, K) layout J is not contiguous: every field a
#: vector kernel reaches is copied).  outop: fy's rows of 257 items are no
#: whole number of words; lapd: a and b start on different float32 phases
#: (J 1 and 3) but on one float64 phase; while: rows of 130 float32 (520
#: bytes); serk is one column-form loop, which has no vector kernel
REPAIRED_KIJ = {"outop": {4: {"fy"}, 8: {"fy"}}, "lapd": {4: {"a"}, 8: set()},
                "while": {4: {"a", "b"}, 8: set()}}


def _fields(name, dtype):
    _, spec, *_ = CASES[name]
    out = {}
    for k, (shape, seed) in spec.items():
        a = np.zeros(shape) if seed is None else np.random.default_rng(seed).random(shape)
        if name == "while" and k == "a":
            a = a * 0.5
        out[k] = a.astype(dtype)
    return out


def _retyped(defn, dtype):
    new = types.FunctionType(defn.__code__, defn.__globals__, defn.__name__)
    new.__annotations__ = {k: jgts.Field[dtype] for k in defn.__annotations__}
    return new


def _jax(defn, backend, arrays, origins, domain):
    st = jgts.stencil(backend=backend, definition=defn, rebuild=True,
                      name=f"{defn.__name__}_{backend}")
    out = {k: v.copy() for k, v in arrays.items()}
    st(**out, origin=dict(origins), domain=domain)
    return out, pb.LAST_PLAN.get(f"{defn.__name__}_{backend}")


def _port(defn, backend, arrays, origins, domain, layout, **options):
    """Run on the port: ``layout`` "ijk" hands the numpy arrays over as they
    are, "kij" as (K, I, J) buffers viewed as (I, J, K).  ``"cuda"`` builds
    K6's vector row form (``tiles=False``, whatever a section's stages)."""
    if backend == "cuda":
        options = {"tiles": False, **options}
    st = pgts.stencil(backend=backend, definition=to_port(defn), rebuild=True, **options)
    if layout == "ijk":
        ts = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    else:
        ts = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(2, 0, 1))).permute(1, 2, 0)
              for k, v in arrays.items()}
    st(**ts, origin=dict(origins), domain=domain)
    return st, {k: v.numpy() for k, v in ts.items()}


@pytest.mark.parametrize("layout", ["ijk", "kij"])
@pytest.mark.parametrize("name", list(CASES))
def test_repair_shapes_vs_pallas_oracle_and_plain(emulated, monkeypatch, name, layout):  # noqa: F811
    """Each shape of test_geometry_repair.py: float32 against the JAX
    package's repaired Pallas kernel and the port's plain executor; float64
    against the numpy oracle and plain.  The plan shows the vector form,
    with a repair where the fields share no phase; every byte of the
    caller's buffers outside the write window keeps its value (plain's)."""
    defn, _, origins, domain, jax_repairs = CASES[name]
    monkeypatch.setattr(jconfig, "ASSUME_TPU_PLANNING", True)
    arrays = _fields(name, np.float32)
    pallas, jplan = _jax(defn, "pallas", arrays, origins, domain)
    if jax_repairs:
        assert jplan and (jplan.get("repair") or jplan.get("repair_domain")), jplan
    for dtype in (np.float32, np.float64):
        d = _retyped(defn, dtype)
        arrays = _fields(name, dtype)
        st, got = _port(d, "cuda", arrays, origins, domain, layout)
        plan = cuda_backend.LAST_PLAN[defn.__name__]
        size = np.dtype(dtype).itemsize
        rows = name != "serk"
        assert st.backend.launches == 1 and plan.get("vector") == (16 // size if rows else None), \
            plan
        if not rows:
            repaired = set()
        elif layout == "ijk":
            repaired = set(arrays)
        else:
            repaired = REPAIRED_KIJ.get(name, {}).get(size, set())
        assert set(plan.get("repair", {})) == repaired, plan
        _, plain = _port(d, "torch", arrays, origins, domain, layout)
        ref = _jax(d, "numpy", arrays, origins, domain)[0] if dtype == np.float64 else pallas
        tol = dict(rtol=1e-12, atol=0) if dtype == np.float64 else dict(rtol=2e-6, atol=2e-7)
        for k in arrays:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=f"{dtype.__name__} {k}")
            np.testing.assert_allclose(got[k], ref[k], err_msg=f"{dtype.__name__} {k}", **tol)


def test_phase_shift_needs_no_copy(emulated):  # noqa: F811
    """HALO-2 buffers, J rows of 516 float32 (2064 bytes, whole words),
    the origin at J element 2: the vector kernels' groups start on the
    common phase (j = 2 mod 4) and no field is copied; at halo 3 (518
    floats a row) every field is."""
    got = {}
    for halo, backend in ((2, "cuda"), (2, "torch"), (3, "cuda"), (3, "torch")):
        shape = (4, 12 + 2 * halo, 512 + 2 * halo)
        a = torch.from_numpy(np.random.default_rng(halo).random(shape).astype(np.float32))
        st = pgts.stencil(backend=backend, definition=to_port(lapd), rebuild=True,
                          **({"tiles": False} if backend == "cuda" else {}))
        fn = st.functional(origin=(halo, halo, 0), domain=(12, 512, 4), physical_layout=True)
        got[(halo, backend)] = fn(a=a, b=torch.zeros_like(a))["b"]
        if backend == "cuda":
            plan = cuda_backend.LAST_PLAN["lapd"]
            assert plan["vector"] == 4, plan
            if halo == 2:
                assert "repair" not in plan and st.backend.repairs == 0, plan
            else:
                assert set(plan["repair"]) == {"a", "b"} and st.backend.repairs == 1, plan
    for halo in (2, 3):
        assert torch.equal(got[(halo, "cuda")], got[(halo, "torch")])


def _tight_hdiff(halo, options):
    st = p_dycore.make_hdiff(np.float32, "cuda", **options)
    shape = (3, 20 + 2 * halo, 24 + 2 * halo)
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.random(shape).astype(np.float32))
    c = torch.from_numpy(0.025 * rng.random(shape).astype(np.float32))
    kw = dict(origin=(halo, halo, 0), domain=(20, 24, 3), physical_layout=True)
    return st, u, c, kw


def test_cost_rule_both_ways(emulated, monkeypatch):  # noqa: F811
    """A repair of at most 4 MiB of copies always pays; above it the
    measured saving per node-point decides: with none, the scalar row form
    runs and the plan records why; with a large one, the repair runs."""
    st, u, c, kw = _tight_hdiff(3, {})
    an = st.backend.analysis
    assert repair.cost_ok(an, repair.SMALL_REPAIR_BYTES, (20, 24, 3))
    fn = st.functional(**kw)
    ref = p_dycore.make_hdiff(np.float32, "torch").functional(**kw)(
        in_field=u, out_field=u, coeff=c)["out_field"]
    monkeypatch.setattr(repair, "SMALL_REPAIR_BYTES", 0)
    for saving, repaired in ((0.0, False), (1.0, True)):
        monkeypatch.setattr(repair, "SAVING_S_PER_NODE_POINT", saving)
        out = fn(in_field=u, out_field=u, coeff=c)["out_field"]
        plan = cuda_backend.LAST_PLAN[st.name]
        assert bool(plan.get("repair")) == repaired, plan
        assert (plan.get("vector") == 4) == repaired, plan
        if not repaired:
            assert plan["declined"]["repair"] == "cost", plan
        assert torch.equal(out, ref)


def test_forced_options_raise_where_they_cannot_apply(emulated):  # noqa: F811
    """``vector=True`` on geometry it cannot take that no repair can fix (a
    periodic call, or ``repair=False``) raises, as does ``repair=True`` on
    a periodic call or on fields that already share a phase; nothing falls
    back to the scalar form quietly."""
    st, u, c, kw = _tight_hdiff(3, {"vector": True})
    with pytest.raises(ValueError, match="periodic call is not repaired"):
        st.functional(**kw, periodic=("I", "J"))(in_field=u, out_field=u, coeff=c)
    st.functional(**kw)(in_field=u, out_field=u, coeff=c)
    assert cuda_backend.LAST_PLAN[st.name]["repair"]
    st, u, c, kw = _tight_hdiff(3, {"vector": True, "repair": False})
    with pytest.raises(ValueError, match="repair=False is not repaired"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)
    st, u, c, kw = _tight_hdiff(3, {"repair": True})
    with pytest.raises(ValueError, match="periodic call is not repaired"):
        st.functional(**kw, periodic=("I", "J"))(in_field=u, out_field=u, coeff=c)
    st, u, c, kw = _tight_hdiff(2, {"repair": True})
    with pytest.raises(ValueError, match="no repair applies"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)


def test_misaligned_vector_access_faults(emulated, monkeypatch):  # noqa: F811
    """A vector kernel launched on a phase its fields do not share faults
    (the emulated runtime checks every 16-byte access, as the card does):
    the launch raises instead of computing from misaligned words; a
    repair's copy off the phase is refused before the launch.  (hdiff's
    tile kernel tests each word's alignment before a 16-byte copy, so the
    vector row form is built here, with ``tiles=False``.)"""
    st, u, c, kw = _tight_hdiff(2, {"tiles": False})
    common_phase = repair.common_phase
    monkeypatch.setattr(repair, "common_phase", lambda cons: 1)
    with pytest.raises(RuntimeError, match="misaligned address"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)
    monkeypatch.setattr(repair, "common_phase", common_phase)
    # the repair's copies are checked before the launch, not assumed
    # aligned: here each lies one element past the allocator's alignment
    pad_fields = repair.pad_fields

    def off_by_one(analysis, views, *args):
        new, origins = pad_fields(analysis, views, *args)
        for n, v in new.items():
            if v is not views[n]:
                ni, nj, nk = v.shape
                t = torch.empty(v.numel() + 1, dtype=v.dtype)[1:].view(nk, ni, nj)
                new[n] = t.permute(1, 2, 0).copy_(v)
        return new, origins

    monkeypatch.setattr(repair, "pad_fields", off_by_one)
    st, u, c, kw = _tight_hdiff(3, {})
    with pytest.raises(RuntimeError, match="not on the vector kernels' 16-byte phase"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)


def test_gradient_through_a_repaired_stencil(emulated):  # noqa: F811
    """K8 around a repaired launch: the primal from the repaired vector
    kernels, the gradient from the plain executor, equal to the plain
    backend's gradient bit for bit."""
    grads = {}
    for backend in ("cuda", "torch"):
        st = p_dycore.make_hdiff(np.float64, backend)
        rng = np.random.default_rng(9)
        # rows of 31 float64 (248 bytes): no whole number of words
        u = torch.from_numpy(rng.random((3, 26, 31))).requires_grad_(True)
        c = torch.from_numpy(0.025 * rng.random((3, 26, 31)))
        fn = st.functional(origin=(3, 3, 0), domain=(20, 24, 3), physical_layout=True)
        # the stencil object is cached: count this call's engagements
        before = (getattr(st.backend, "derivative_calls", 0), getattr(st.backend, "repairs", 0))
        out = fn(in_field=u, out_field=u, coeff=c)["out_field"]
        (grads[backend],) = torch.autograd.grad((out ** 2).sum(), [u])
        if backend == "cuda":
            assert (st.backend.derivative_calls - before[0], st.backend.repairs - before[1]) == (1, 1)
            assert cuda_backend.LAST_PLAN[st.name]["repair"]
    assert torch.equal(grads["cuda"], grads["torch"])
