"""The CUDA source emitter (``backend="cuda"``): the dycore, FV and
semi-Lagrangian stencils, and ``while``, regions, variable/absolute K and
data dimensions.

The emitter does not inline temporaries (``passes.inline_parallel_
temporaries``, which the ``"jax"`` backend applies): the horizontal
diffusion is one tile kernel -- the Laplacian, the limited fluxes and the
update its stages -- with ``lap_field``, ``flx_field`` and ``fly_field`` in
shared planes and ``res`` in a register; built with ``tiles=False`` it is
three row-form kernels with those temporaries in scratch, and fv_step
thirteen.
"""

import re

import numpy as np
import pytest

from gt4py_tpu_torch.cartesian import gtscript, ir
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.models import dycore, fv_advection, semi_lagrangian
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


#: stencil -> the kernel forms it documents, in launch order: a column
#: loop ("columns") is launched only as K4's window kernel; the fused
#: column kernel ("column") runs the loops in one pass
FORMS = {
    "make_hdiff": ["tile"],
    "make_vadv": ["columns", "columns", "column"],
    "make_vadv_update": ["columns", "columns", "column"],
    # split by default (``cuda_backend.SERIALIZE_MIXED``): the PARALLEL
    # loop's tile kernel, then the serial loops' fused column kernel
    "make_dycore_fused": ["tile", "columns", "columns", "column"],
}
#: stencils whose column loops K4 declines (so they have no kernel of
#: their own): the fused step's split build promotes ``flx_field``, which
#: has I/J halos
NO_K4 = {"make_dycore_fused"}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("factory", list(FORMS))
def test_source_is_deterministic_with_documented_stages(factory, dtype):
    st = getattr(dycore, factory)(dtype, backend="cuda")
    again = cuda_backend.generate(st.analysis)
    assert again.source == st.backend.source
    assert [k.form for k in again.kernels] == FORMS[factory]
    # every row stage reaches a J-contiguous field: it has a vector kernel
    # (K6) beside its scalar one, and gt_run launches one of the two
    assert [k.vector is not None for k in again.kernels] == [
        f == "rows" for f in FORMS[factory]]
    # every column loop has K4's variant beside it (the default runs it
    # from ``KB_DEFAULT_DEPTH`` levels), the fused step's too
    k4 = factory not in NO_K4
    assert [k.window is not None for k in again.kernels] == [
        f == "columns" and k4 for f in FORMS[factory]]
    n = len(FORMS[factory]) + FORMS[factory].count("rows") - (
        0 if k4 else FORMS[factory].count("columns"))
    # a tile kernel that stages 16-byte rows has a twin for calls whose
    # staged rows share one lead (K6), and gt_run launches one of the two
    twins = FORMS[factory].count("tile")
    assert st.backend.source.count("__global__") == n + twins
    assert st.backend.source.count("<<<") == n + twins
    # every launch is counted and followed by a launch-error check
    assert st.backend.source.count("cudaGetLastError()") == n
    assert st.backend.source.count("++gt_launches_;") == n
    # the source note names the TPU kernel it replaces and the bound
    assert "pallas_backend.py:1428 PallasBackend._pallas_trace" in st.backend.source
    assert "Bound on the H100: device-memory bandwidth" in st.backend.source


def test_hdiff_without_temporary_inlining():
    prog = dycore.make_hdiff(np.float32, backend="cuda").backend.program
    (k,) = prog.kernels
    assert k.form == "tile" and prog.scratch == []
    assert sorted(k.planes.shared) == ["flx_field", "fly_field", "lap_field"]
    assert k.planes.registers == ["res"]
    # the stage-split build (``tiles=False``)
    prog = dycore.make_hdiff(np.float32, backend="cuda", tiles=False).backend.program
    assert prog.scratch == ["lap_field", "flx_field", "fly_field"]
    assert prog.locals == ["res"]
    # the stages compute over the extended rectangles of the extent analysis
    rects = [(k.rect.i, k.rect.j) for k in prog.kernels]
    assert rects == [((-1, 1), (-1, 1)), ((-1, 0), (-1, 0)), ((0, 0), (0, 0))]


def test_vadv_recurrences_read_the_previous_level():
    src = dycore.make_vadv_update(np.float32, backend="cuda").backend.source
    assert "t_dcol.at(i + 0, j + 0, k + -1)" in src  # FORWARD: dcol[0, 0, -1]
    assert "t_datacol.at(i + 0, j + 0, k + 1)" in src  # BACKWARD: datacol[0, 0, 1]
    assert re.search(r"for \(int k = kb\.hi\[\d\] - 1; k >= kb\.lo\[\d\]; --k\)", src)


_FLOAT_LITERAL = re.compile(r"-?0x[0-9a-f]\.[0-9a-f]+p[+-]\d+f?")


@pytest.mark.parametrize("factory", list(FORMS))
def test_float32_source_has_no_double_literal(factory):
    """Every float literal of a float32 stencil is a float (``f`` suffix)
    and no kernel declares a double: a bare ``1.0`` would move the float32
    Thomas chain to double.  (The host launcher receives float scalars as
    doubles and converts them once.)"""
    src = getattr(dycore, factory)(np.float32, backend="cuda").backend.source
    kernels = src.split('extern "C"')[0]
    lits = _FLOAT_LITERAL.findall(kernels)
    assert lits and all(lit.endswith("f") for lit in lits)
    assert "double" not in kernels
    src64 = getattr(dycore, factory)(np.float64, backend="cuda").backend.source
    kernels64 = src64.split('extern "C"')[0]
    assert all(not lit.endswith("f") for lit in _FLOAT_LITERAL.findall(kernels64))
    assert "float " not in kernels64 and "float>" not in kernels64


def test_literals_are_exact():
    assert cuda_backend._literal(0.1, np.float32) == f"({float(np.float32(0.1)).hex()}f)"
    assert float.fromhex(cuda_backend._literal(0.1, np.float64)[1:-1]) == 0.1
    assert cuda_backend._literal(3, np.int32) == "((int)3LL)"
    assert cuda_backend._literal(True, np.bool_) == "true"


def test_periodic_wrap_only_on_read_only_fields():
    src = dycore.make_hdiff(np.float32, backend="cuda").backend.source
    # staged into the tile kernel's ring (row gi, column gj, level gk)
    assert "f_in_field.at(gt::wrap(gi + 0, dI, pI), gt::wrap(gj + 0, dJ, pJ), gk + 0)" in src
    assert "f_in_field.at(gt::wrap(i + 1, dI, pI), gt::wrap(j + 0, dJ, pJ), k + 0)" in \
        dycore.make_hdiff(np.float32, backend="cuda", tiles=False).backend.source
    assert "f_out_field.at(i + 0, j + 0, k + 0) =" in src  # written: no wrap
    assert "f_coeff.at(i + 0, j + 0, k + 0)" in src  # read at offset 0 only


def test_scalars_are_kernel_arguments_in_their_dtype():
    src = dycore.make_vadv_update(np.float32, backend="cuda").backend.source
    assert "float s_dtr_stage" in src
    assert "const float s_dtr_stage = (float)fsc[0];" in src


def test_while_raises_not_implemented():
    """``while`` used to be outside the emitters; it is now a loop in the
    thread, the statement one row-form unit."""
    F = gtscript.Field[np.float64]

    def halve(a: F):
        with computation(PARALLEL), interval(...):
            while a > 1.0:
                a = a / 2.0

    st = gtscript.stencil(backend="cuda", definition=halve, rebuild=True)
    src = st.backend.source
    assert "while ((f_a.at(i + 0, j + 0, k + 0) > (0x1.0000000000000p+0))) {" in src
    assert len(st.backend.program.kernels) == 1


def test_variable_k_reads_run_the_staged_window_or_a_clipped_load():
    """Variable K used to be outside the emitters.  A PARALLEL stage reads
    it from the staged form's shared-memory window (``vk0_``) at the level
    clipped to the buffer (``kclamp``), the window's rows staged with
    16-byte copies; built ``stage_vark=False`` it is a direct clipped load
    from device memory, as in the column form."""
    F = gtscript.Field[np.float64]

    def shift(inp: F, idx: gtscript.Field[np.int64], out: F):
        with computation(PARALLEL), interval(...):
            out = inp[0, 0, idx]

    st = gtscript.stencil(backend="cuda", definition=shift, rebuild=True)
    assert [k.form for k in st.backend.program.kernels] == ["vark"]
    src = st.backend.source
    assert "vk0_(f_inp.kclamp(k + f_idx.at(i + 0, j + 0, k + 0)))" in src
    assert "gt::async_copy<16>(d_, a_);" in src and "atomicAdd(vko_, vkn_)" in src
    st = gtscript.stencil(backend="cuda", definition=shift, rebuild=True, stage_vark=False)
    assert [k.form for k in st.backend.program.kernels] == ["rows"]
    assert "f_inp.at(i + 0, j + 0, f_inp.kclamp(k + f_idx.at(i + 0, j + 0, k + 0)))" \
        in st.backend.source

    def scan(inp: F, idx: gtscript.Field[np.int64], out: F):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, idx]

    st = gtscript.stencil(backend="cuda", definition=scan, rebuild=True)
    assert [k.form for k in st.backend.program.kernels] == ["columns", "column"]
    # the fused kernel loads idx one level ahead, into a register
    assert "f_inp.at(i + 0, j + 0, f_inp.kclamp(k + v0_))" in st.backend.source
    st = gtscript.stencil(backend="cuda", definition=scan, rebuild=True, fuse_loops=False)
    assert [k.form for k in st.backend.program.kernels] == ["columns"]
    assert "f_inp.at(i + 0, j + 0, f_inp.kclamp(k + f_idx.at(i + 0, j + 0, k + 0)))" \
        in st.backend.source


def test_k_invariant_absolute_reads_load_once_clipped_to_the_buffer():
    """A read at an absolute K from a literal, a scalar or an IJ field is
    clipped to the buffer and loaded once, into a register, before the
    row kernel's K loop, which reads the register."""
    F = gtscript.Field[np.float64]

    def plane(a: F, out: F, kidx: gtscript.Field[gtscript.IJ, np.int64], *, s: int):
        with computation(PARALLEL), interval(...):
            out = a.at(K=2) + a.at(K=s) + a.at(K=kidx)

    src = gtscript.stencil(backend="cuda", definition=plane, rebuild=True).backend.source
    body = src[src.index("__global__"):]
    loop = body.index("for (int k")
    for n, index in enumerate(["((long long)2LL)", "s_s",
                               "f_kidx.at(i + 0, j + 0, 0)"]):  # an IJ field: no K axis
        assert f"const double hk{n}_ = f_a.at(i + 0, j + 0, f_a.kclamp({index}));" \
            in body[:loop]
    assert "kclamp" not in body[loop:body.index("\n}\n")]
    assert "= ((hk0_ + hk1_) + hk2_);" in body


def _assign(target, value):
    return ir.Assign(target=ir.FieldAccess(target), value=value)


@pytest.mark.parametrize("offset", [
    ir.VariableKOffset(ir.FieldAccess("idx")),
    ir.AbsoluteKIndex(ir.Literal(2, np.dtype(np.int64))),
    ir.CartesianOffset(0, 0, 1),
], ids=["variable_k", "absolute_k", "k_offset"])
def test_nonuniform_k_read_of_a_field_written_in_the_stage_starts_a_stage(offset):
    """In the row form every thread sweeps K itself: a read of another
    level of a field written earlier in the stage would see a level the
    thread has not written yet, so it starts a new stage (the validator
    refuses such reads within one PARALLEL loop; the splitter does not
    rely on it)."""
    stmts = [
        _assign("t", ir.FieldAccess("a")),
        _assign("b", ir.FieldAccess("a")),
        _assign("out", ir.FieldAccess("t", offset=offset)),
    ]
    assert [len(s) for s in cuda_backend._split_stages(stmts)] == [2, 1]
    # ... and so does a write of a field read that way earlier in the stage
    stmts = [_assign("out", ir.FieldAccess("t", offset=offset)),
             _assign("t", ir.FieldAccess("a"))]
    assert [len(s) for s in cuda_backend._split_stages(stmts)] == [1, 1]
    # a read at the thread's own level stays in the stage
    stmts = [_assign("t", ir.FieldAccess("a")), _assign("out", ir.FieldAccess("t"))]
    assert [len(s) for s in cuda_backend._split_stages(stmts)] == [2]


def test_variable_k_read_of_a_temporary_zero_fills_it():
    """A variable-K read may reach any level, some never written: the
    scratch buffer starts at zero, as the oracle's temporaries do."""
    from gt4py_tpu_torch.testing import SURFACE

    st = gtscript.stencil(backend="cuda", definition=SURFACE["variable_k_after_write"][0],
                          rebuild=True)
    assert st.backend.program.scratch == ["t"]
    assert _zeroed(st, 8) == ["t"]


def test_region_guards_resolve_against_the_true_domain():
    """START and END anchors of a region compare the thread's position
    with the domain sizes, not with the kernel's rectangle: those of the
    region frame (the point at ``i + gI0`` of a ``gNI`` x ``gNJ`` domain;
    ``gt_run`` passes ``(0, 0, dI, dJ)`` unless the call gives a frame),
    which the stencil's kernels take since it has regions."""
    from gt4py_tpu_torch import testing

    entry = testing.load_stencil_defs()["horizontal_regions"]
    src = gtscript.stencil(backend="cuda", definition=entry["definition"],
                           rebuild=True).backend.source
    assert ("if (((i + gI0) >= 0 && (i + gI0) < 2 && (j + gJ0) >= 0 && (j + gJ0) < 2) || "
            "((i + gI0) >= (gNI + -3) && (i + gI0) < (gNI + -1) && (j + gJ0) >= (gNJ + -3) && "
            "(j + gJ0) < (gNJ + -1))) {") in src
    assert "const int gI0 = dom[3], gJ0 = dom[4], gNI = dom[5], gNJ = dom[6];" in src
    m = ir.HorizontalMask(i=ir.HorizontalInterval(None, ir.AxisBound.end(1)),
                          j=ir.HorizontalInterval(ir.AxisBound.start(-2), None))
    assert cuda_backend._region_test([m]) == "(i < (dI + 1) && j >= -2)"
    assert cuda_backend._region_test([m], framed=True) == "((i + gI0) < (gNI + 1) && (j + gJ0) >= -2)"
    assert cuda_backend._region_test([ir.HorizontalMask()]) == "true"


def test_data_dims_fold_constant_components_and_wrap_dynamic_ones():
    from gt4py_tpu_torch.testing import SURFACE

    src = gtscript.stencil(backend="cuda", definition=SURFACE["data_dims_writes"][0],
                           rebuild=True).backend.source
    assert "f_w.at(i + 0, j + 0, k + 0, 1 * f_w.sd[0] + 0 * f_w.sd[1]) =" in src
    # w[0, 0, 0][0, 1] = vec[0, 0, 0][-1]: a negative index counts from the end
    assert ("f_w.at(i + 0, j + 0, k + 0, 0 * f_w.sd[0] + 1 * f_w.sd[1]) = "
            "f_vec.at(gt::wrap(i + 0, dI, pI), j + 0, k + 0, 2 * f_vec.sd[0]);") in src
    src = gtscript.stencil(backend="cuda", definition=SURFACE["data_dims_dynamic_write"][0],
                           rebuild=True).backend.source
    assert "gt::imod<long long>(" in src and ", 3LL) * f_vec.sd[0]" in src


def test_data_dim_access_without_every_index_raises():
    prog_ir = ir.Stencil(
        name="s", api_params=[], scalar_decls={}, temp_decls={},
        field_decls={"v": ir.FieldDecl("v", np.dtype(np.float64), data_dims=(3,)),
                     "o": ir.FieldDecl("o", np.dtype(np.float64))},
        vertical_loops=[ir.VerticalLoop(ir.LoopOrder.PARALLEL, [ir.VerticalSection(
            ir.Interval.full(), [_assign("o", ir.FieldAccess("v"))])])],
    )
    from gt4py_tpu_torch.cartesian.analysis import analyze

    with pytest.raises(NotImplementedError, match="accessed with 0 indices"):
        cuda_backend.generate(analyze(prog_ir))


def test_bool_temporary_across_stages_is_a_bool_scratch():
    F = gtscript.Field[np.float64]

    def flags(a: F, b: F):
        with computation(PARALLEL), interval(...):
            m = a > 0.5
            b = 1.0 if m[1, 0, 0] else 0.0

    prog = gtscript.stencil(backend="cuda", definition=flags, rebuild=True).backend.program
    # the tile form: one kernel, m in a shared plane of bools
    assert prog.scratch == [] and len(prog.kernels) == 1
    assert "bool* const sh_m" in prog.source
    prog = gtscript.stencil(backend="cuda", definition=flags, rebuild=True,
                            tiles=False).backend.program
    assert prog.scratch == ["m"] and len(prog.kernels) == 2
    assert "gt::Field<bool> t_m" in prog.source


def test_fv_step_stages():
    """fv_step: the PARALLEL section is one tile kernel of 13 stages, the
    temporaries read at an offset or in a later stage in shared planes
    (30, in fewer slots), the rest (including the bool limiter flags) in
    registers.  Split (``tiles=False``) it is 13 row-form stages, those 30
    temporaries in scratch."""
    prog = fv_advection.make_fv_step(np.float32, backend="cuda").backend.program
    (k,) = prog.kernels
    assert k.form == "tile" and len(k.planes.stages[0]) == 13 and prog.scratch == []
    assert len(k.planes.shared) == 30 and len(k.planes.registers) == 24
    assert len(k.tile.slot_bytes) < 30 and {"smx", "smy", "qx", "fy"} <= set(
        k.planes.registers) | set(k.planes.shared)
    prog = fv_advection.make_fv_step(np.float32, backend="cuda", tiles=False).backend.program
    assert [k.form for k in prog.kernels] == ["rows"] * 13
    assert len(prog.scratch) == 30 and len(prog.locals) == 24
    assert {"smx", "smy", "smfx", "smfy"} <= set(prog.locals)
    assert {"qx", "qy", "fx", "fy"} <= set(prog.scratch)
    # the widest stage computes the cross-advected qx/qy halo
    assert max(k.rect.i[1] - k.rect.i[0] for k in prog.kernels) == 6


@pytest.mark.parametrize("factory", ["fv_step", "sl_step"])
def test_fv_and_sl_float32_sources_have_no_double(factory):
    st = fv_advection.make_fv_step(np.float32, backend="cuda") if factory == "fv_step" else \
        semi_lagrangian.make_sl_stencil(np.float32, backend="cuda")
    kernels = st.backend.source.split('extern "C"')[0]
    lits = _FLOAT_LITERAL.findall(kernels)
    assert lits and all(lit.endswith("f") for lit in lits)
    assert "double" not in kernels
    # 7/12 and 2/3 are computed in float32 at run time, as the IR says
    if factory == "fv_step":
        assert f"({float(7.0).hex()}f) / ({float(12.0).hex()}f)" in kernels


def test_horizontal_offset_read_in_its_own_serial_loop_raises():
    """Such a loop used to be refused; it now runs in the plane-sweep form
    (``t`` in one shared plane per CTA), and equals the plain executor on
    CPU tensors (the emulated kernels: ``tests/test_torch_plane.py``)."""
    F = gtscript.Field[np.float64]

    def sweep(a: F, b: F):
        with computation(FORWARD), interval(...):
            t = a + 1.0
            b = t[1, 0, 0]

    st = gtscript.stencil(backend="cuda", definition=sweep, rebuild=True)
    assert [k.form for k in st.backend.program.kernels] == ["planes"]
    assert cuda_backend.LAST_PLAN["sweep"]["shared"] == ["t"]
    assert "double* const sh_t" in st.backend.source
    a = np.random.default_rng(0).random((9, 6, 4))
    got, ref = np.zeros_like(a), np.zeros_like(a)
    st(a, got, domain=(8, 6, 4))
    ref[:8] = a[1:9] + 1.0
    np.testing.assert_array_equal(got, ref)


def test_build_key_covers_source_header_and_flags():
    from gt4py_tpu_torch.cartesian.backend import _build

    a = _build.build_key("x")
    assert a == _build.build_key("x") and a != _build.build_key("y")


@pytest.mark.parametrize("name", ["lower_dim", "conditionals", "builtins", "integers",
                                  "runtime_interval", "tridiagonal",
                                  "temp_reads_unwritten"])
def test_card_test_stencils_generate(name):
    """The stencils the card tests launch are inside the emitters' subset."""
    from .test_torch_cuda import DEFS

    st = gtscript.stencil(backend="cuda", definition=DEFS[name], rebuild=True)
    kernels = st.backend.program.kernels
    # a column loop the fused kernel runs emits only its K4 variant
    assert st.backend.source.count("__global__") == sum(not k.k4_only for k in kernels) + sum(
        k.vector is not None for k in kernels) + sum(k.window is not None for k in kernels) >= 1


def _zeroed(st, dK, scalars=None):
    prog = st.backend.program
    kb = [(max(a, 0), min(b, dK)) for a, b in
          (itv.resolve(dK, scalars or {}) for itv in prog.intervals)]
    return cuda_backend.zero_init_temps(prog, kb)


@pytest.mark.parametrize("factory", list(FORMS))
def test_dycore_scratch_needs_no_zero_fill(factory):
    """Every level the dycore stencils read of a scratch temporary was
    written first (the Thomas recurrences read the level just written)."""
    st = getattr(dycore, factory)(np.float32, backend="cuda")
    assert _zeroed(st, 80) == [] and _zeroed(st, 3) == []


def test_scratch_read_before_write_is_zero_filled():
    """The oracle's temporaries start at zero: a temporary read beyond the
    levels written, or a level before it is written, is zero-filled."""
    from .test_torch_cuda import DEFS

    st = gtscript.stencil(backend="cuda", definition=DEFS["temp_reads_unwritten"],
                          rebuild=True)
    assert sorted(_zeroed(st, 7)) == ["t", "w"]
    tri = gtscript.stencil(backend="cuda", definition=DEFS["tridiagonal"], rebuild=True)
    assert _zeroed(tri, 7) == []

