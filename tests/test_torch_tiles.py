"""The tile form (K1) and the fused column kernel (K2) on the emulated
kernels, against the JAX package.

The ``"cuda"`` backend runs each PARALLEL section of a stencil as one tile
kernel (its stages in one CTA a tile, stage intermediates in shared planes
reused by liveness, its read-only inputs staged a level ahead) and each run
of consecutive serial loops as one fused column kernel (a thread a column
through every loop, recurrence carries in registers).  Here the kernels are
built by the host compiler against the emulated runtime of
``tests/test_torch_emulated.py`` and held to the JAX package -- its numpy
oracle and ``"pallas"`` (interpret mode on the CPU) at rtol 1e-12 / atol
1e-12 in float64 -- and to the port's plain executor and its split builds
(``tiles=False``: the stage-split row kernels; ``fuse_loops=False``: one
column kernel a loop) bit for bit in float32.  ``cuda_backend.LAST_PLAN``
must show the form that ran, the stencil's library the kernels it launched.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.models import dycore as j_dycore
from gt4py_tpu.models import fv_advection as j_fv
from gt4py_tpu.models import semi_lagrangian as j_sl
from gt4py_tpu.models import shallow_water as j_sw

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import analysis as p_analysis
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.cartesian.analysis import _stmt_reads, _stmt_writes
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.models import dycore, fv_advection, semi_lagrangian, shallow_water

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


#: buffers of halo 3 around a 16 x 24 x 6 domain
DOMAIN = (16, 24, 6)
ORIGIN = (3, 3, 0)
BUFFER = (22, 30, 6)
TOL = dict(rtol=1e-12, atol=1e-12)

#: name -> (port factory, JAX factory, fields, written, scalars, default
#: forms, kernels a call launches)
MODELS = {
    "hdiff": (dycore.make_hdiff, j_dycore.make_hdiff, ["in_field", "out_field", "coeff"],
              ["out_field"], {}, ["tile"], 1),
    "fv_step": (fv_advection.make_fv_step, j_fv.make_fv_step, ["q", "cx", "cy", "qout"],
                ["qout"], {}, ["tile"], 1),
    "sw_step": (shallow_water.make_sw_step, j_sw.make_sw_step,
                ["h", "u", "v", "h_new", "u_new", "v_new"], ["h_new", "u_new", "v_new"], {},
                ["tile"], 1),
    "sl_step": (semi_lagrangian.make_sl_stencil, j_sl.make_sl_stencil,
                ["q", "u", "v", "qout"], ["qout"], {"dtdx": 1.0, "dtdy": 1.0}, ["tile"], 1),
    "vadv_update": (dycore.make_vadv_update, j_dycore.make_vadv_update,
                    ["utens_stage", "u_stage", "wcon", "u_pos", "utens", "u_out"],
                    ["utens_stage", "u_out"], {"dtr_stage": 3.0}, ["column"], 1),
    "dycore_fused": (dycore.make_dycore_fused, j_dycore.make_dycore_fused,
                     ["u", "coeff", "wcon", "utens", "utens_stage", "u_out"],
                     ["utens_stage", "u_out"], {"dtr_stage": 3.0}, ["tile", "column"], 2),
}
#: the split build each is held against
SPLIT = {"vadv_update": {"fuse_loops": False},
         "dycore_fused": {"fuse_loops": False, "tiles": False}}
#: the build options that give the new form where it is not the default:
#: sl_step's one stage runs the row kernel unless forced
FORCE = {"sl_step": {"tiles": True}}


def _arrays(name, dtype, seed=0, shape=BUFFER):
    rng = np.random.default_rng(seed)
    fields = MODELS[name][2]
    out = {n: rng.random(shape).astype(dtype) for n in fields}
    if name in ("fv_step", "sl_step"):  # Courant numbers and winds in (-0.4, 0.4)
        for n in fields[1:3]:
            out[n] = (0.8 * rng.random(shape) - 0.4).astype(dtype)
    return out


def _port(name, dtype, arrays, backend="cuda", periodic=(), domain=DOMAIN, origin=ORIGIN,
          **options):
    make, _, _, written, scalars, _, _ = MODELS[name]
    st = make(dtype, backend, **options)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    before = st.backend.device_launches()["all"] if backend == "cuda" else 0
    st(**out, **scalars, origin=origin, domain=domain, periodic=periodic)
    counted = st.backend.device_launches()["all"] - before if backend == "cuda" else 0
    return st, {k: out[k].numpy() for k in written}, counted


def _jax(name, backend, arrays, periodic):
    _, make, _, written, scalars, _, _ = MODELS[name]
    st = make(np.float64, backend)
    out = {k: v.copy() for k, v in arrays.items()}
    st(**out, **scalars, origin=ORIGIN, domain=DOMAIN, periodic=periodic)
    return {k: np.asarray(out[k]) for k in written}


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("name", list(MODELS))
def test_models_emulated_vs_oracle_and_pallas(emulated, name, periodic):  # noqa: F811
    """Each main-path stencil in its new form -- one tile kernel per
    PARALLEL section (forced for sl_step's one stage), the fused column
    kernel for the serial loops -- equals
    the JAX package's numpy oracle and its Pallas kernels (interpret mode)
    at rtol 1e-12 in float64; its forms from ``LAST_PLAN`` and its kernel
    launches counted by its library.  (Pallas runs the periodic calls, as
    the models make them: its interpret mode compiles for seconds a call.)"""
    arrays = _arrays(name, np.float64)
    ref = _jax(name, "numpy", arrays, periodic)
    pallas = _jax(name, "pallas", arrays, periodic) if periodic else ref
    st, got, counted = _port(name, np.float64, arrays, periodic=periodic,
                             **FORCE.get(name, {}))
    plan = cuda_backend.LAST_PLAN[st.name]
    forms, launches = MODELS[name][5:]
    assert plan["forms"] == forms and counted == launches, (plan, counted)
    assert "tiles" not in plan["declined"] and "fuse_loops" not in plan["declined"], plan
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[k], **TOL, err_msg=k)
        np.testing.assert_allclose(v, pallas[k], **TOL, err_msg=k)


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("name", list(MODELS))
def test_models_float32_bitwise_vs_split_and_plain(emulated, name, periodic):  # noqa: F811
    """float32: the new form (as in the test above) equals its split build
    (the stage-split row kernels, or one column kernel a loop) and the
    plain executor bit for bit."""
    arrays = _arrays(name, np.float32, seed=1)
    _, got, _ = _port(name, np.float32, arrays, periodic=periodic, **FORCE.get(name, {}))
    st, split, _ = _port(name, np.float32, arrays, periodic=periodic,
                         **SPLIT.get(name, {"tiles": False}))
    assert "tile" not in cuda_backend.LAST_PLAN[st.name]["forms"]
    assert "column" not in cuda_backend.LAST_PLAN[st.name]["forms"]
    _, plain, _ = _port(name, np.float32, arrays, backend="torch", periodic=periodic)
    for k, v in got.items():
        np.testing.assert_array_equal(v, split[k], err_msg=k)
        np.testing.assert_array_equal(v, plain[k], err_msg=k)


def test_one_stage_runs_the_tile_form():
    """sl_step's one stage, which keeps nothing in shared planes, runs the
    tile form when forced (``tiles=True``; its q staged for its 16 offset
    reads); by default, as with ``tiles=False``, it declines by
    ``ONE_STAGE`` to its vector row kernel."""
    prog = semi_lagrangian.make_sl_stencil(np.float32, "cuda", tiles=True).backend.program
    (k,) = prog.kernels
    assert k.form == "tile" and not k.planes.shared and "tiles" not in prog.declined
    assert [n for n, *_ in k.tile.inputs] == ["q"]
    for tiles in (None, False):
        prog = semi_lagrangian.make_sl_stencil(np.float32, "cuda", tiles=tiles).backend.program
        assert [k.form for k in prog.kernels] == ["rows"] and prog.kernels[0].vector
        assert prog.declined.get("tiles") == (cuda_backend.ONE_STAGE if tiles is None
                                              else None)


def test_column_store_in_device_memory_on_a_deep_column(emulated):  # noqa: F811
    """The whole-column temporaries (ccol, dcol) of a deep column stream
    through their device-memory scratch, the carry (datacol) stays in
    registers: the same values as the per-loop kernels and plain, bit for
    bit."""
    shape, domain = (6, 10, 160), (4, 8, 160)
    arrays = _arrays("vadv_update", np.float64, seed=2, shape=shape)
    kw = dict(domain=domain, origin=(1, 1, 0))
    st, got, counted = _port("vadv_update", np.float64, arrays, **kw)
    (col,) = cuda_backend.LAST_PLAN[st.name]["columns"]
    assert col["kernel"] == st.backend.program.kernels[-1].name
    assert sorted(col["columns"]) == ["ccol", "dcol"] and col["carries"] == ["datacol"], col
    assert counted == 1
    _, split, _ = _port("vadv_update", np.float64, arrays, fuse_loops=False, **kw)
    _, plain, _ = _port("vadv_update", np.float64, arrays, backend="torch", **kw)
    for k, v in got.items():
        np.testing.assert_array_equal(v, split[k], err_msg=k)
        np.testing.assert_array_equal(v, plain[k], err_msg=k)


def test_staged_inputs_take_sixteen_byte_copies_on_the_phase(emulated):  # noqa: F811
    """hdiff's in_field is staged into the tile kernel's ring with 16-byte
    copies from each row's aligned-down word, whatever the row's phase: in
    (K, I, J) buffers with rows of 33 float32 (132 bytes, so the rows of a
    level start on every phase) at J origin 4; with element copies where J
    is not contiguous (the (I, J, K) layout).  ``LAST_PLAN`` names the
    staging; no call is repaired; the results equal each other and plain."""
    arrays = _arrays("hdiff", np.float32, seed=3, shape=(22, 33, 6))
    got, copies = {}, {}
    for layout in ("kij", "ijk", "plain"):
        st = dycore.make_hdiff(np.float32, "cuda" if layout != "plain" else "torch")
        if layout == "kij":
            out = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(2, 0, 1))).permute(1, 2, 0)
                   for k, v in arrays.items()}
        else:
            out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
        if layout != "plain":
            count = st.backend.build().gt_emu_copies16_count
            before = count()
        st(**out, origin=(3, 4, 0), domain=DOMAIN)
        if layout != "plain":
            copies[layout] = count() - before
            plan = cuda_backend.LAST_PLAN[st.name]
            want = "row_phase" if layout == "kij" else "element"
            assert plan["staging"] == {"in_field": want} and "repair" not in plan, plan
        got[layout] = out["out_field"].contiguous()
    assert copies["kij"] > 0 and copies["ijk"] == 0
    assert torch.equal(got["kij"], got["plain"]) and torch.equal(got["ijk"], got["plain"])


# --------------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------------- #


def _live(pp, sid):
    """Each shared plane's first and last stage (a mirrored plane from
    the level's start)."""
    live = {}
    for n, stage in enumerate(pp.stages[sid]):
        for s in stage:
            for node in ir.walk_values(s):
                if isinstance(node, ir.FieldAccess) and node.name in pp.shared:
                    a, b = live.get(node.name, (n, n))
                    live[node.name] = (min(a, n), max(b, n))
    for name in pp.mirrored:
        live[name] = (-1, live[name][1])
    return live


@pytest.mark.parametrize("name", [n for n in MODELS if "tile" in MODELS[n][5]])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_no_two_live_shared_planes_share_a_slot(name, dtype):
    """Planes whose stages overlap never share a slot; every slot holds
    its largest plane; the shared bytes leave at least two CTAs a SM."""
    st = MODELS[name][0](dtype, "cuda")
    for k in st.backend.program.kernels:
        if k.tile is None:
            continue
        tp = k.tile
        ((sid, _),) = k.sections
        live = _live(tp.planes, sid)
        assert set(live) == set(tp.slot) == set(tp.planes.shared)
        for a in live:
            for b in live:
                if a < b and tp.slot[a] == tp.slot[b]:
                    assert live[a][1] < live[b][0] or live[b][1] < live[a][0], (a, b)
        TI, TJ = tp.tile
        for n, e in tp.planes.shared.items():
            size = (TI + e.i[1] - e.i[0]) * (TJ + e.j[1] - e.j[0]) * np.dtype(dtype).itemsize
            assert size <= tp.slot_bytes[tp.slot[n]]
        assert tp.smem_bytes == sum(tp.slot_bytes) + 2 * tp.input_bytes
        assert cuda_backend.ctas_per_sm(tp.smem_bytes, cuda_backend.PLANE_THREADS) >= 2
        assert tp.halo >= 1.0


def test_fv_step_reuses_slots():
    """fv_step's 30 shared planes need far fewer slots than planes."""
    prog = fv_advection.make_fv_step(np.float32, "cuda").backend.program
    (k,) = prog.kernels
    (rec,) = prog.plan_record()["tiles"]
    assert rec["planes"] == 30 and rec["slots"] == len(k.tile.slot_bytes) < 15
    assert rec["staged"] == ["q@k0"]


def test_vadv_update_carries_never_touch_device_memory():
    """The fused column kernel keeps datacol in registers (carried) and
    ccol/dcol in registers plus one store a level; no level reads device
    memory for the level before."""
    st = dycore.make_vadv_update(np.float32, "cuda")
    (col,) = [k for k in st.backend.program.kernels if k.group]
    assert col.group.carries == ["datacol"] and col.group.columns == ["ccol", "dcol"]
    src = st.backend.source
    body = src[src.index(f"void __launch_bounds__({cuda_backend.COL_THREADS}, "
                         f"{cuda_backend.COL_MIN_CTAS}) {col.name}("):]
    body = body[:body.index("\n}\n")]
    assert "t_datacol." not in body and "t_dcol.at(i + 0, j + 0, k + -1)" not in body
    assert "p_dcol = kl_ == k - 1 ? c_dcol" in body and "p_datacol = kl_ == k - -1" in body
    assert "m_ccol[(long long)k * ms_ccol] = c_ccol;" in body


#: one-section stencils for the declines (raw IR: the validator refuses
#: some of these patterns in GTScript)
def _stencil(stmts, temps=(), data_temps=()):
    f64 = np.dtype(np.float64)
    fields = {n: ir.FieldDecl(n, f64) for n in ("a", "b")}
    temp_decls = {n: ir.FieldDecl(n, f64) for n in temps}
    temp_decls.update({n: ir.FieldDecl(n, f64, data_dims=(2,)) for n in data_temps})
    return p_analysis.analyze(ir.Stencil(
        name="decl", api_params=[], scalar_decls={}, temp_decls=temp_decls, field_decls=fields,
        vertical_loops=[ir.VerticalLoop(ir.LoopOrder.PARALLEL, [ir.VerticalSection(
            ir.Interval.full(), stmts)])]))


def _assign(target, value, offset=None, data=()):
    return ir.Assign(target=ir.FieldAccess(target, data_index=data),
                     value=value if not isinstance(value, str) else ir.FieldAccess(
                         value, offset=offset or ir.CartesianOffset()))


_ZERO = ir.Literal(0, np.dtype(np.int64))
DECLINES = {
    "k_offset": (lambda: _stencil([_assign("t", "a"),
                                   _assign("b", "t", ir.CartesianOffset(0, 0, 1))], ["t"]),
                 "a K-offset read of 't'"),
    "data_dims": (lambda: _stencil([
        ir.Assign(target=ir.FieldAccess("t", data_index=(_ZERO,)), value=ir.FieldAccess("a")),
        ir.Assign(target=ir.FieldAccess("b"), value=ir.FieldAccess(
            "t", offset=ir.CartesianOffset(1, 0, 0), data_index=(_ZERO,)))], data_temps=["t"]),
        "data dimensions or no I/J axis"),
    # (an ``if`` of this kind is split into a mask and one statement each,
    # ``passes.split_compound_statements``; a ``while`` cannot be, and the
    # tile form iterates one whose condition reads only its own point,
    # ``_loop_group``: this one's reads its neighbour's)
    "compound": (lambda: _stencil([
        _assign("t", "a"),
        ir.While(cond=ir.BinaryOp(ir.BinaryOperator.LT, ir.FieldAccess(
            "t", offset=ir.CartesianOffset(1, 0, 0)), ir.Literal(0.5, np.dtype(np.float64))),
            body=[ir.Assign(target=ir.FieldAccess("t"), value=ir.BinaryOp(
                ir.BinaryOperator.ADD, ir.FieldAccess("t"),
                ir.Literal(1.0, np.dtype(np.float64))))]),
        _assign("b", "t")], ["t"]),
        "a while condition reads at a horizontal offset a field its loop writes"),
}


@pytest.mark.parametrize("why", list(DECLINES))
def test_declines_are_recorded_and_tiles_true_raises(why, monkeypatch):
    """Where the tile form cannot run a section, the default build keeps
    the stage-split row kernels and records the reason by name; a build
    with ``tiles=True`` raises it.  (The validator refuses the K-offset
    read in GTScript; raw IR, as the next bridge builds it, is not
    validated for it here, and the planner does not rely on it.)"""
    from gt4py_tpu_torch.cartesian import validation

    monkeypatch.setattr(validation, "validate", lambda stencil: None)
    make, reason = DECLINES[why]
    an = make()
    if why != "compound":  # the row form refuses that statement too
        prog = cuda_backend.generate(an)
        assert "tile" not in [k.form for k in prog.kernels]
        assert reason in prog.declined["tiles"], prog.declined
    with pytest.raises(NotImplementedError, match=reason.split("'")[0]):
        cuda_backend.generate(an, tiles=True)


def test_shared_bytes_above_the_limit_decline(monkeypatch):
    """Shared planes and staged inputs beyond ``SMEM_MAX`` at the smallest
    tile decline the form.  (Planned from the analysis: a build here
    would replace the cached hdiff of the other tests.)"""
    an = dycore.make_hdiff(np.float32, "cuda").analysis
    monkeypatch.setattr(cuda_backend, "SMEM_MAX", 64)
    prog = cuda_backend.generate(an)
    assert [k.form for k in prog.kernels] == ["rows"] * 3
    assert "bytes at a (1, 32) tile, above 64" in prog.declined["tiles"]
    with pytest.raises(NotImplementedError, match="above 64"):
        cuda_backend.generate(an, tiles=True)


P = pgts.Field[np.float64]


def crossed(a: P, b: P, c: P):
    with computation(FORWARD), interval(...):
        t = a + 1.0
        b = t
    with computation(BACKWARD), interval(...):
        c = t[1, 0, 0] * 2.0 + b


def test_fusion_declines_a_horizontal_read_across_loops(emulated):  # noqa: F811
    """Loops that read, at a horizontal offset, a field another writes get
    a fused kernel each (recorded); ``fuse_loops=True`` raises."""
    st = pgts.stencil(backend="cuda", definition=crossed, rebuild=True)
    plan = cuda_backend.LAST_PLAN["crossed"]
    assert plan["forms"] == ["column", "column"] and "horizontal offset" in \
        plan["declined"]["fuse_loops"], plan
    rng = np.random.default_rng(4)
    arrays = {k: rng.random((10, 9, 5)) for k in "abc"}
    got = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    st(**got, origin=(1, 1, 0), domain=(8, 7, 5))
    ref = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    pgts.stencil(backend="torch", definition=crossed, rebuild=True)(
        **ref, origin=(1, 1, 0), domain=(8, 7, 5))
    for k in "bc":
        assert torch.equal(got[k], ref[k]), k
    with pytest.raises(NotImplementedError, match="fuse_loops=True"):
        pgts.stencil(backend="cuda", definition=crossed, rebuild=True, fuse_loops=True)


REGISTRY = testing.load_stencil_defs()


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_canonical_stencils_run_tiles_or_record_why(name):
    """Every canonical stencil of ``tests/cartesian/stencil_defs.py``: each
    PARALLEL section the default build does not serialize runs in the tile
    form, or the build records why it declined; each run of column loops
    runs in a fused kernel, or the build records why not."""
    d, _, kw = testing.registry_case(REGISTRY[name])
    st = pgts.stencil(backend="cuda", definition=d, rebuild=True,
                      externals=kw.get("externals", {}))
    prog = st.backend.program
    plan = cuda_backend.LAST_PLAN[st.analysis.stencil.name]
    forms = [k.form for k in prog.kernels]
    # a declined section runs as row stages: the row kernels, or the staged
    # form where a stage reads a field at a variable K
    assert bool({"rows", "vark"} & set(forms)) == ("tiles" in plan["declined"]), plan
    if "columns" in forms:
        assert "column" in forms, plan
    for k in prog.kernels:
        if k.tile is not None:
            assert k.order == ir.LoopOrder.PARALLEL and len(k.sections) == 1
        if k.group is not None:
            names = {w.name for _, body in k.sections for s in body for w in _stmt_writes(s)}
            assert set(k.group.writer) <= names | set(prog.analysis.stencil.temp_decls)
            for t in k.group.carries + k.group.columns:
                reads = [r for _, body in k.sections for s in body for r in _stmt_reads(s)
                         if r.name == t]
                assert all(r.offset.i == r.offset.j == 0 for r in reads)
