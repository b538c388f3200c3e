"""K6 on the emulated kernels: row-phase staging, the vector row form and
the forced repair.

The tile kernels stage each row of an input from its own aligned-down
16-byte word, so no kernel of the ``"cuda"`` backend needs one phase across
fields to be repaired for.  The row stages' vector kernels (V consecutive J
points a thread, 16-byte loads and stores) run where every J-contiguous
field they reach shares one 16-byte phase, the scalar row kernels
elsewhere; by default no call is repaired, and ``repair=True`` still runs
the JAX package's pass (``cartesian/backend/repair.py``: copies in each
field's read window at a common phase, runs, copies each written field's
write window back).  Here the kernels are built by the host compiler
against the emulated runtime of ``tests/test_torch_emulated.py``, whose
16-byte accesses fault on a misaligned address or outside the fields'
storages, and held on the shapes of
``tests/cartesian/test_geometry_repair.py``:

- against the JAX package's ``"pallas"`` under ``ASSUME_TPU_PLANNING``
  (interpret mode, its repair path) at rtol 2e-6 / atol 2e-7 in float32
  (XLA's fused multiply-adds: a few float32 ulps);
- against its numpy oracle at rtol 1e-12 in float64 (the host's ``sin``
  and ``exp`` differ from numpy's by an ulp);
- against the port's plain executor bit for bit in both,

each in the JAX tests' layout (numpy (I, J, K) arrays, J not contiguous:
the scalar row kernels, or the repair when forced) and in the models'
(K, I, J) layout.
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
from gt4py_tpu_torch.cartesian.backend import _build, cuda_backend, repair
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


#: the item sizes at which a case's fields share no 16-byte phase in the
#: (K, I, J) layout (the row-phase twins' calls): outop's
#: fy has rows of 257 items, no whole number of words; lapd's a and b start
#: on different float32 phases (J 1 and 3) but on one float64 phase;
#: while's rows of 130 float32 are 520 bytes
NO_PHASE_KIJ = {"outop": {4, 8}, "lapd": {4}, "while": {4}}


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


def _launched(st, run):
    """``run()``'s kernel launches by form, as the stencil's library counts
    them (``CudaBackend.launches_by_form``)."""
    st.backend.build()
    before = st.backend.device_launches()
    out = run()
    now = st.backend.device_launches()
    delta = {k: [a - b for a, b in zip(now[k], before[k])] if isinstance(now[k], list)
             else now[k] - before[k] for k in now}
    return out, st.backend.launches_by_form(delta)


def _port(defn, backend, arrays, origins, domain, layout, **options):
    """Run on the port: ``layout`` "ijk" hands the numpy arrays over as they
    are, "kij" as (K, I, J) buffers viewed as (I, J, K).  ``"cuda"`` builds
    K6's vector row form (``tiles=False``, whatever a section's stages)
    and returns the launches by form (``_launched``) too."""
    if backend == "cuda":
        options = {"tiles": False, **options}
    st = pgts.stencil(backend=backend, definition=to_port(defn), rebuild=True, **options)
    if layout == "ijk":
        ts = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    else:
        ts = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(2, 0, 1))).permute(1, 2, 0)
              for k, v in arrays.items()}
    if backend != "cuda":
        st(**ts, origin=dict(origins), domain=domain)
        return st, {k: v.numpy() for k, v in ts.items()}
    _, forms = _launched(st, lambda: st(**ts, origin=dict(origins), domain=domain))
    return st, {k: v.numpy() for k, v in ts.items()}, forms


@pytest.mark.parametrize("layout", ["ijk", "kij"])
@pytest.mark.parametrize("name", list(CASES))
def test_repair_shapes_vs_pallas_oracle_and_plain(emulated, monkeypatch, name, layout):  # noqa: F811
    """Each shape of test_geometry_repair.py by default -- no copy --
    float32 against the JAX package's repaired Pallas kernel and the port's
    plain executor, float64 against the numpy oracle and plain.  By
    default the plan shows the vector row form on (K, I, J) buffers whose
    fields share a 16-byte phase, the scalar row form elsewhere (where
    they share none, ``NO_PHASE_KIJ``, because the row-phase twins ran
    slower: ``ROW_PHASE_SLOWER``; on (I, J, K) arrays because J is not
    contiguous), and no repair; on (K, I, J) buffers ``vector=True`` runs
    the vector kernels or, where the fields share no phase, their
    row-phase twins, every launch of a row stage a vector one by the
    library's count; in the (I, J, K) layout ``repair=True`` still copies
    every field (none shares a phase) and runs the vector form on the
    copies, with the same result.  Every byte of the caller's buffers
    outside the write window keeps its value (plain's)."""
    defn, _, origins, domain, jax_repairs = CASES[name]
    monkeypatch.setattr(jconfig, "ASSUME_TPU_PLANNING", True)
    arrays = _fields(name, np.float32)
    pallas, jplan = _jax(defn, "pallas", arrays, origins, domain)
    if jax_repairs:
        assert jplan and (jplan.get("repair") or jplan.get("repair_domain")), jplan
    rows = name != "serk"
    contiguous = layout == "kij"
    for dtype in (np.float32, np.float64):
        d = _retyped(defn, dtype)
        arrays = _fields(name, dtype)
        _, plain = _port(d, "torch", arrays, origins, domain, layout)
        ref = _jax(d, "numpy", arrays, origins, domain)[0] if dtype == np.float64 else pallas
        tol = dict(rtol=1e-12, atol=0) if dtype == np.float64 else dict(rtol=2e-6, atol=2e-7)
        size = np.dtype(dtype).itemsize
        runs = [{}] + ([{"repair": True}] if not contiguous else [{"vector": True}])
        for options in runs:
            st, got, forms = _port(d, "cuda", arrays, origins, domain, layout, **options)
            plan = cuda_backend.LAST_PLAN[defn.__name__]
            phase = contiguous and size not in NO_PHASE_KIJ.get(name, ())
            vector = rows and (phase or bool(options))
            assert st.backend.launches == 1, plan
            assert plan.get("vector") == (16 // size if vector else None), plan
            assert forms == {"vector" if vector else "rows" if rows else "column": 1}, plan
            if vector and contiguous:
                twin = "_v" if phase else "_vr"
                assert plan["vector_phase"] == ("common" if phase else "row"), plan
                assert plan["vector_rows"] == [k.name + twin
                                               for k in st.backend.program.kernels], plan
            elif rows and not options:
                assert plan["declined"]["vector"] == cuda_backend.ROW_PHASE_SLOWER \
                    if contiguous else "not J-contiguous" in plan["declined"]["vector"], plan
            if "repair" in options:
                assert set(plan["repair"]) == set(arrays) and st.backend.repairs == 1, plan
            else:
                assert "repair" not in plan and "repair_bytes" not in plan, plan
                assert st.backend.repairs == 0, plan
            for k in arrays:
                msg = f"{dtype.__name__} {k} {options}"
                np.testing.assert_array_equal(got[k], plain[k], err_msg=msg)
                np.testing.assert_allclose(got[k], ref[k], err_msg=msg, **tol)


def test_phase_shift_needs_no_copy(emulated):  # noqa: F811
    """HALO-2 buffers, J rows of 516 float32 (2064 bytes, whole words),
    the origin at J element 2: the vector kernels' groups start on the
    common phase (j = 2 mod 4) and no field is copied; at halo 3 (518
    floats a row: the rows alternate between two phases) no field is
    copied either: the scalar row kernels run on the caller's buffers, and
    with ``vector=True`` the vector kernels' row-phase twins."""
    got = {}
    for halo, backend, options in ((2, "cuda", {}), (2, "torch", {}), (3, "cuda", {}),
                                   (3, "cuda", {"vector": True}), (3, "torch", {})):
        shape = (4, 12 + 2 * halo, 512 + 2 * halo)
        a = torch.from_numpy(np.random.default_rng(halo).random(shape).astype(np.float32))
        st = pgts.stencil(backend=backend, definition=to_port(lapd), rebuild=True,
                          **({"tiles": False, **options} if backend == "cuda" else {}))
        fn = st.functional(origin=(halo, halo, 0), domain=(12, 512, 4), physical_layout=True)
        got[(halo, backend, bool(options))] = fn(a=a, b=torch.zeros_like(a))["b"]
        if backend == "cuda":
            plan = cuda_backend.LAST_PLAN["lapd"]
            vector = halo == 2 or bool(options)
            assert plan.get("vector") == (4 if vector else None), plan
            assert plan.get("vector_phase") == (None if not vector else "common" if halo == 2
                                                else "row"), plan
            assert "repair" not in plan and st.backend.repairs == 0, plan
    for key, b in got.items():
        assert torch.equal(b, got[(key[0], "torch", False)]), key


def _tight_hdiff(halo, options):
    st = p_dycore.make_hdiff(np.float32, "cuda", **options)
    shape = (3, 20 + 2 * halo, 24 + 2 * halo)
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.random(shape).astype(np.float32))
    c = torch.from_numpy(0.025 * rng.random(shape).astype(np.float32))
    kw = dict(origin=(halo, halo, 0), domain=(20, 24, 3), physical_layout=True)
    return st, u, c, kw


def _ijk_hdiff(options):
    """hdiff's row kernels on (I, J, K) arrays (J not contiguous)."""
    st = p_dycore.make_hdiff(np.float32, "cuda", tiles=False, **options)
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.random((26, 30, 3)).astype(np.float32))
    c = torch.from_numpy(0.025 * rng.random((26, 30, 3)).astype(np.float32))
    return st, u, c, dict(origin=(3, 3, 0), domain=(20, 24, 3))


def test_cost_rule_both_ways(emulated):  # noqa: F811
    """No cost rule is left to decide: by default a call is never repaired,
    whether its copies would be small or large -- tight hdiff at halo 3
    runs on the caller's buffers, its input staged at each row's phase --
    and ``repair=True`` always repairs a non-periodic call whose fields
    share no phase.  Both equal plain bit for bit."""
    ref = None
    for options, repaired in (({}, False), ({"repair": True}, True)):
        st, u, c, kw = _tight_hdiff(3, options)
        if ref is None:
            ref = p_dycore.make_hdiff(np.float32, "torch").functional(**kw)(
                in_field=u, out_field=u, coeff=c)["out_field"]
        before = st.backend.repairs
        out = st.functional(**kw)(in_field=u, out_field=u, coeff=c)["out_field"]
        plan = cuda_backend.LAST_PLAN[st.name]
        assert (st.backend.repairs - before == 1) == repaired, plan
        assert bool(plan.get("repair")) == repaired and plan["staging"] == {
            "in_field": "row_phase"}, plan
        assert "repair" not in plan["declined"], plan
        assert torch.equal(out, ref)


def test_forced_options_raise_where_they_cannot_apply(emulated):  # noqa: F811
    """``vector=True`` on fields that are not J-contiguous, where no repair
    can fix them (a periodic call, or ``repair=False``), raises, and
    repairs them where it can; on J-contiguous fields that share no phase
    (tight halo 3) it runs the row-phase twins on the caller's buffers,
    bounded and periodic, and copies nothing; ``repair=True`` on a
    periodic call or on fields that already share a phase raises; nothing
    falls back to the scalar form quietly."""
    st, u, c, kw = _tight_hdiff(3, {"tiles": False, "vector": True})
    for periodic in ((), ("I", "J")):
        ref = p_dycore.make_hdiff(np.float32, "torch").functional(**kw, periodic=periodic)(
            in_field=u, out_field=u, coeff=c)["out_field"]
        out, forms = _launched(st, lambda: st.functional(**kw, periodic=periodic)(
            in_field=u, out_field=u, coeff=c)["out_field"])
        plan = cuda_backend.LAST_PLAN[st.name]
        assert forms == {"vector": 3} and plan["vector_phase"] == "row", (forms, plan)
        assert "repair" not in plan and st.backend.repairs == 0, plan
        assert torch.equal(out, ref)
    st, u, c, kw = _ijk_hdiff({"vector": True})
    with pytest.raises(ValueError, match="periodic call is not repaired"):
        st.functional(**kw, periodic=("I", "J"))(in_field=u, out_field=u, coeff=c)
    st.functional(**kw)(in_field=u, out_field=u, coeff=c)
    plan = cuda_backend.LAST_PLAN[st.name]
    assert plan["repair"] and plan["vector"] == 4, plan
    st, u, c, kw = _ijk_hdiff({"vector": True, "repair": False})
    with pytest.raises(ValueError, match="repair=False is not repaired"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)
    st, u, c, kw = _tight_hdiff(3, {"repair": True})
    with pytest.raises(ValueError, match="periodic call is not repaired"):
        st.functional(**kw, periodic=("I", "J"))(in_field=u, out_field=u, coeff=c)
    st, u, c, kw = _tight_hdiff(2, {"repair": True})
    with pytest.raises(ValueError, match="no repair applies"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)


def _offset_hdiff(options, patch, build, monkeypatch):
    """hdiff on (K, I, J) buffers whose storages start 4 bytes into a
    16-byte word (numpy arrays one element in), rows of 29 float32 (116
    bytes: every phase), the domain reaching the buffers' first element,
    built by ``build`` from its source patched by ``patch``: (call, plain
    result)."""
    monkeypatch.setattr(_build, "build", lambda src, name: build(patch(src), name))
    st = p_dycore.make_hdiff(np.float32, "cuda", rebuild=True, **options)
    rng = np.random.default_rng(8)
    shape = (3, 24, 29)
    ts = {}
    for k in ("in_field", "coeff"):
        buf = np.empty(int(np.prod(shape)) + 1, dtype=np.float32)[1:].reshape(shape)
        buf[...] = rng.random(shape)
        ts[k] = torch.from_numpy(buf)
    kw = dict(origin=(2, 2, 0), domain=(20, 25, 3), physical_layout=True)
    args = dict(in_field=ts["in_field"], out_field=ts["in_field"], coeff=ts["coeff"])
    ref = p_dycore.make_hdiff(np.float32, "torch").functional(**kw)(**args)["out_field"]
    return lambda: st.functional(**kw)(**args)["out_field"], ref


def test_misaligned_vector_access_faults(emulated, monkeypatch):  # noqa: F811
    """The emulated runtime faults on a 16-byte access that is misaligned
    or leaves the fields' storages, as the card does; so the kernels' row
    leads, storage tests and phases are what keep each word aligned and in
    bounds.  On fields whose storages start one element into a word:
    unpatched, the tile kernel and the vector row kernels' row-phase twins
    equal plain; with the staging's row lead dropped and its alignment test
    stripped, or the twins' window lead dropped, the launch raises a
    misaligned address; with the staging's or the twins' storage test
    stripped, the first rows' aligned-down words start before the storage
    and the launch raises.  A vector row kernel launched on a phase its
    fields do not share raises; a repair's copy off the phase is refused
    before the launch."""
    build = _build.build
    twin = {"tiles": False, "vector": True}
    for options in ({}, twin):
        run, ref = _offset_hdiff(options, lambda src: src, build, monkeypatch)
        assert torch.equal(run(), ref)
    assert cuda_backend.LAST_PLAN["hdiff_float32"]["vector_phase"] == "row"
    faults = [
        ({}, lambda src: src.replace("gt::lead16(&", "0 * gt::lead16(&").replace(
            "(reinterpret_cast<size_t>(a_) & 15) == 0 && ", ""), "misaligned address"),
        ({}, lambda src: src.replace(".holds16(a_)", ".holds16(a_) || true"),
         "outside the fields' storage"),
        (twin, lambda src: src.replace("const int s_ = gt::lead16(p_);",
                                       "const int s_ = 0 * gt::lead16(p_);"), "misaligned address"),
        (twin, lambda src: src.replace("const bool in_ = ", "const bool in_ = true || "),
         "outside the fields' storage"),
    ]
    for options, patch, match in faults:
        src = p_dycore.make_hdiff(np.float32, "cuda", rebuild=True, **options).backend.source
        assert patch(src) != src
        run, _ = _offset_hdiff(options, patch, build, monkeypatch)
        with pytest.raises(RuntimeError, match=match):
            run()
    monkeypatch.setattr(_build, "build", build)
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
    st, u, c, kw = _ijk_hdiff({"vector": True})
    with pytest.raises(RuntimeError, match="not on the vector kernels' 16-byte phase"):
        st.functional(**kw)(in_field=u, out_field=u, coeff=c)


def test_gradient_through_a_repaired_stencil(emulated):  # noqa: F811
    """K8 around a repaired launch (``repair=True``): the primal from the
    kernels on the repair's copies, the gradient from the plain executor,
    equal to the plain backend's gradient bit for bit."""
    grads = {}
    for backend in ("cuda", "torch"):
        st = p_dycore.make_hdiff(np.float64, backend,
                                 **({"repair": True} if backend == "cuda" else {}))
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
