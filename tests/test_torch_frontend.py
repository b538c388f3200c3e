"""The port's copies of the language layers (parser, IR, analysis,
validation, passes) give the same IR, extents, boundaries and loop/section
structure as ``gt4py_tpu``'s, so the copies cannot drift.

Definitions written against ``gt4py_tpu.cartesian.gtscript`` are carried
over to the port by ``to_port``: the same source and code object, with the
annotations, globals and closure cells mapped to the port's gtscript.
"""

import dataclasses
import enum
import types

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.frontend import parse_definition as j_parse
from gt4py_tpu.cartesian import analysis as j_analysis
from gt4py_tpu.cartesian import passes as j_passes
from gt4py_tpu.models import dycore as j_dycore

from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.frontend import parse_definition as p_parse
from gt4py_tpu_torch.cartesian import analysis as p_analysis
from gt4py_tpu_torch.cartesian import passes as p_passes
from gt4py_tpu_torch.models import dycore as p_dycore

from .cartesian import stencil_defs
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")



def _translate(v, seen):
    if isinstance(v, jgts._FieldDescriptor):
        axes = tuple(pgts.Axis(n) for n in v.axes_names)
        return pgts._FieldDescriptor(v.dtype, axes, v.data_dims)
    if isinstance(v, jgts.GTScriptFunction):
        return pgts.GTScriptFunction(to_port(v.definition, seen))
    if isinstance(v, jgts.AxisIndex):
        return pgts.AxisIndex(v.axis, v.index, v.offset)
    if isinstance(v, types.ModuleType) and v is jgts:
        return pgts
    return v


def to_port(fn, seen=None):
    """The definition ``fn`` with its gtscript objects mapped to the port's."""
    seen = {} if seen is None else seen
    if id(fn) in seen:
        return seen[id(fn)]
    g = {k: _translate(v, seen) for k, v in fn.__globals__.items()}
    cells = None
    if fn.__closure__:
        cells = tuple(types.CellType(_translate(c.cell_contents, seen)) for c in fn.__closure__)
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, cells)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__annotations__ = {k: _translate(v, seen) for k, v in fn.__annotations__.items()}
    seen[id(fn)] = new
    return new


def dump(obj, skip=("sources",)):
    """A structural, package-independent dump of IR and analysis objects."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, dump(getattr(obj, f.name), skip))
            for f in dataclasses.fields(obj) if f.name not in skip
        )
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if isinstance(obj, dict):
        return tuple((k, dump(v, skip)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return tuple(dump(v, skip) for v in obj)
    if isinstance(obj, np.dtype):
        return str(obj)
    return obj


def _stmt_units(stencil):
    return [s for loop in stencil.vertical_loops for sec in loop.sections for s in sec.body]


def assert_same_analysis(ja, pa):
    # IR (loops, sections, statements, declarations, dtypes)
    assert dump(pa.stencil) == dump(ja.stencil)
    # per-field extents, boundaries and access
    assert dump(pa.field_info) == dump(ja.field_info)
    assert dump(pa.parameter_info) == dump(ja.parameter_info)
    assert pa.k_boundary == ja.k_boundary
    assert pa.min_k_size == ja.min_k_size
    names = list(ja.stencil.field_decls) + list(ja.stencil.temp_decls)
    for n in names:
        assert dump(pa.extents.field_extent(n)) == dump(ja.extents.field_extent(n)), n
        assert dump(pa.extents.alloc_extent(n)) == dump(ja.extents.alloc_extent(n)), n
    # per-statement compute extents, in program order
    for js, ps in zip(_stmt_units(ja.stencil), _stmt_units(pa.stencil), strict=True):
        assert dump(pa.extents.stmt_extent(ps)) == dump(ja.extents.stmt_extent(js))


def _analyze(parse, passes, analysis, definition, **kw):
    ir_ = passes.widen_f16_compute(parse(definition, **kw))
    return analysis.analyze(ir_)


DYCORE_FACTORIES = ["make_hdiff", "make_vadv", "make_vadv_update", "make_dycore_fused"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("factory", DYCORE_FACTORIES)
def test_dycore_stencils_same_analysis(factory, dtype):
    ja = getattr(j_dycore, factory)(dtype, backend="numpy").analysis
    pa = getattr(p_dycore, factory)(dtype, backend="torch").analysis
    assert_same_analysis(ja, pa)


@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_stencil_defs_same_analysis(name):
    entry = stencil_defs.REGISTRY[name]
    ja = _analyze(j_parse, j_passes, j_analysis, entry["definition"],
                  externals=entry["externals"])
    pa = _analyze(p_parse, p_passes, p_analysis, to_port(entry["definition"]),
                  externals=entry["externals"])
    assert_same_analysis(ja, pa)


def test_inline_parallel_temporaries_same():
    """The temporary-inlining pass (the "jax" backend applies it; the
    port's "cuda" backend does not) gives the same IR in both copies."""
    ja = j_dycore.make_hdiff(np.float64, backend="numpy").analysis
    pa = p_dycore.make_hdiff(np.float64, backend="torch").analysis
    j_in = j_passes.inline_parallel_temporaries(ja.stencil)
    p_in = p_passes.inline_parallel_temporaries(pa.stencil)
    assert dump(p_in) == dump(j_in)
    assert len(p_in.temp_decls) < len(pa.stencil.temp_decls)


def test_validation_errors_match():
    """A racy definition is refused by both copies of the validator."""
    from gt4py_tpu.cartesian.validation import GTScriptValidationError as JErr
    from gt4py_tpu_torch.cartesian.validation import GTScriptValidationError as PErr

    F = jgts.Field[np.float64]

    def racy(a: F, b: F):
        with computation(PARALLEL), interval(...):  # noqa: F821
            a = a[1, 0, 0] + b

    with pytest.raises(JErr):
        _analyze(j_parse, j_passes, j_analysis, racy)
    with pytest.raises(PErr):
        _analyze(p_parse, p_passes, p_analysis, to_port(racy))
