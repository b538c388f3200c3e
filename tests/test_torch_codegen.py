"""The CUDA source emitter (``backend="cuda"``) on the dycore stencils.

The emitter does not inline temporaries (``passes.inline_parallel_
temporaries``, which the ``"jax"`` backend applies): the horizontal
diffusion is three row-form kernels -- the Laplacian, the limited fluxes,
the update -- with ``lap_field``, ``flx_field`` and ``fly_field`` in scratch
and ``res`` in a register.
"""

import re

import numpy as np
import pytest

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.models import dycore

#: stencil -> the kernel forms it documents, in launch order
FORMS = {
    "make_hdiff": ["rows", "rows", "rows"],
    "make_vadv": ["columns", "columns"],
    "make_vadv_update": ["columns", "columns"],
    "make_dycore_fused": ["rows", "rows", "rows", "columns", "columns"],
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("factory", list(FORMS))
def test_source_is_deterministic_with_documented_stages(factory, dtype):
    st = getattr(dycore, factory)(dtype, backend="cuda")
    again = cuda_backend.generate(st.analysis)
    assert again.source == st.backend.source
    assert [k.form for k in again.kernels] == FORMS[factory]
    assert st.backend.source.count("__global__") == len(FORMS[factory])
    assert st.backend.source.count("<<<") == len(FORMS[factory])
    # every launch is followed by a launch-error check
    assert st.backend.source.count("cudaGetLastError()") == len(FORMS[factory])
    # the source note names the TPU kernel it replaces and the bound
    assert "pallas_backend.py:1428 PallasBackend._pallas_trace" in st.backend.source
    assert "Bound on the H100: device-memory bandwidth" in st.backend.source


def test_hdiff_without_temporary_inlining():
    prog = dycore.make_hdiff(np.float32, backend="cuda").backend.program
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
    assert "f_in_field.at(gt::wrap(i + 1, dI, pI), gt::wrap(j + 0, dJ, pJ), k + 0)" in src
    assert "f_out_field.at(i + 0, j + 0, k + 0) =" in src  # written: no wrap
    assert "f_coeff.at(i + 0, j + 0, k + 0)" in src  # read at offset 0 only


def test_scalars_are_kernel_arguments_in_their_dtype():
    src = dycore.make_vadv_update(np.float32, backend="cuda").backend.source
    assert "float s_dtr_stage" in src
    assert "const float s_dtr_stage = (float)fsc[0];" in src


def test_while_raises_not_implemented():
    F = gtscript.Field[np.float64]

    def halve(a: F):
        with computation(PARALLEL), interval(...):
            while a > 1.0:
                a = a / 2.0

    with pytest.raises(NotImplementedError, match="While"):
        gtscript.stencil(backend="cuda", definition=halve, rebuild=True)
    gtscript.stencil(backend="torch", definition=halve, rebuild=True)  # plain: fine


def test_variable_k_offset_raises_not_implemented():
    F = gtscript.Field[np.float64]

    def shift(inp: F, idx: gtscript.Field[np.int64], out: F):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, idx]

    with pytest.raises(NotImplementedError, match="VariableKOffset"):
        gtscript.stencil(backend="cuda", definition=shift, rebuild=True)


def test_horizontal_offset_read_in_its_own_serial_loop_raises():
    F = gtscript.Field[np.float64]

    def sweep(a: F, b: F):
        with computation(FORWARD), interval(...):
            t = a + 1.0
            b = t[1, 0, 0]

    with pytest.raises(NotImplementedError, match="horizontal offset"):
        gtscript.stencil(backend="cuda", definition=sweep, rebuild=True)


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
    assert st.backend.source.count("__global__") == len(st.backend.program.kernels) >= 1


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

