"""K6's row-phase vector twins on the emulated kernels.

A row stage's vector kernel (V consecutive J points a thread, 16-byte
loads and stores) needs its fields on one 16-byte phase; its twin
``<stage>_vr``, which only a ``vector=True`` build emits, runs where they
share none but are J-contiguous -- the models' tight halo-3 buffers,
whose rows alternate between two leads -- loading each window from its
own aligned-down word and realigning it in registers (by default the
scalar row kernels run there: the twins ran slower on the card,
``ROW_PHASE_SLOWER``).  Here the kernels are built by the host compiler
against the emulated runtime of ``tests/test_torch_emulated.py`` (a misaligned 16-byte
access, or one outside the fields' storages, faults the launch), on
(K, I, J) buffers whose storages start one element into a 16-byte word,
bounded and periodic:

- hdiff built ``tiles=False`` (three row stages) and sl_step (one) in
  float32 on halo-3 buffers, against the JAX package's ``"pallas"`` under
  ``ASSUME_TPU_PLANNING`` (interpret mode, its repair path) at rtol 2e-6 /
  atol 2e-7 (XLA's fused multiply-adds: a few float32 ulps);
- hdiff in float64 on rows of an odd number of items, against the JAX
  package's numpy oracle at rtol 1e-12;
- the float16 hdiff-and-sweep stencil (V = 8) against the numpy oracle
  exactly;

each bit for bit against the port's plain executor, every row stage's
launch counted by the library as a vector one, none as a scalar row one.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu import config as jconfig
from gt4py_tpu.models import dycore as j_dycore
from gt4py_tpu.models import semi_lagrangian as j_sl

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.models import dycore as p_dycore
from gt4py_tpu_torch.models import semi_lagrangian as p_sl

from .test_torch_emulated import _f16_jax_def, emulated, emulated_dir  # noqa: F401
from .test_torch_repair import _launched

H = 3


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def _sl(dtype):
    def make(backend, **options):
        if backend in ("pallas", "numpy"):
            return j_sl.make_sl_stencil(dtype, backend, 1)
        return p_sl.make_sl_stencil(dtype, backend, 1, **options)
    return make


def _hdiff(dtype):
    def make(backend, **options):
        if backend in ("pallas", "numpy"):
            return j_dycore.make_hdiff(dtype, backend)
        return p_dycore.make_hdiff(dtype, backend, **options)
    return make


def _f16_sweep(backend, **options):
    if backend == "numpy":
        return _f16_jax_def()
    definition = testing.SURFACE["float16_hdiff_sweep"][0]
    return pgts.stencil(backend=backend, definition=definition, rebuild=True, **options)


#: case -> (factory(backend, **options), dtype, domain, {field: scale or
#: None (zeros)}, scalars, the JAX package's backend and tolerance).  The
#: domains give J rows that are no whole number of 16-byte words, and (but
#: for float64) levels that are not either, so the lead of a row changes
#: with I and K
CASES = {
    "hdiff_f32": (_hdiff(np.float32), np.float32, (11, 20, 3),
                  {"in_field": 1.0, "out_field": None, "coeff": 0.025}, {},
                  "pallas", dict(rtol=2e-6, atol=2e-7)),
    "sl_step_f32": (_sl(np.float32), np.float32, (11, 20, 3),
                    {"q": 1.0, "u": 0.9, "v": 0.9, "qout": None},
                    {"dtdx": 0.7, "dtdy": 0.7}, "pallas", dict(rtol=2e-6, atol=2e-7)),
    "hdiff_f64_odd_pitch": (_hdiff(np.float64), np.float64, (12, 19, 3),
                            {"in_field": 1.0, "out_field": None, "coeff": 0.025}, {},
                            "numpy", dict(rtol=1e-12, atol=0)),
    "f16_sweep": (_f16_sweep, np.float16, (11, 18, 3),
                  {"inp": 1.0, "coeff": 0.025, "out": None, "col": None}, {},
                  "numpy", dict(rtol=0, atol=0)),
}


def _buffers(case, seed=0):
    """Halo-3 (K, I, J) numpy buffers whose storages start one element
    into a 16-byte word; winds centred on 0."""
    _, dtype, (ni, nj, nk), spec, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    shape = (nk, ni + 2 * H, nj + 2 * H)
    out = {}
    for name, scale in spec.items():
        buf = np.empty(int(np.prod(shape)) + 1, dtype=dtype)[1:].reshape(shape)
        if scale is None:
            buf[...] = 0
        else:
            a = rng.random(shape)
            buf[...] = scale * (2 * a - 1 if name in ("u", "v") else a)
        out[name] = buf
    return out


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("case", list(CASES))
def test_row_phase_twin_vs_jax_and_plain(emulated, monkeypatch, case, periodic):  # noqa: F811
    make, dtype, domain, spec, scalars, jax_backend, tol = CASES[case]
    monkeypatch.setattr(jconfig, "ASSUME_TPU_PLANNING", True)
    arrays = _buffers(case)
    kw = dict(origin=(H, H, 0), domain=domain, physical_layout=True, periodic=periodic)
    plain = _buffers(case)
    ref = make("torch").functional(**kw)(
        **{k: torch.from_numpy(v) for k, v in plain.items()}, **scalars)
    st = make("cuda", tiles=False, vector=True)
    got, forms = _launched(st, lambda: st.functional(**kw)(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **scalars))
    plan = cuda_backend.LAST_PLAN[st.name]
    rows = sum(k.form == "rows" for k in st.backend.program.kernels)
    assert rows and forms.get("vector") == rows and "rows" not in forms, (forms, plan)
    assert plan["vector_phase"] == "row" and "repair" not in plan, plan
    assert plan["vector_rows"] == [k.name + "_vr" for k in st.backend.program.kernels
                                   if k.form == "rows"], plan
    assert plan["vector"] == 16 // np.dtype(dtype).itemsize, plan
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    # the JAX package on (I, J, K) copies of the same buffers
    jarr = {k: np.ascontiguousarray(v.transpose(1, 2, 0)) for k, v in _buffers(case).items()}
    make(jax_backend)(**jarr, **scalars, origin=(H, H, 0), domain=domain, periodic=periodic)
    for k, v in got.items():
        want = jarr[k].transpose(2, 0, 1)
        np.testing.assert_allclose(v.numpy().astype(np.float64), want.astype(np.float64),
                                   err_msg=k, **tol)


def test_twin_needs_j_contiguous_rows(emulated):  # noqa: F811
    """Where a field is not J-contiguous (numpy (I, J, K) arrays) the scalar
    row kernels run, and the plan says why the twin did not; by default,
    and with ``vector=False``, the twin does not run on tight buffers
    either, and the plan says why."""
    for options, layout in (({}, "ijk"), ({}, "kij"), ({"vector": False}, "kij")):
        arrays = _buffers("hdiff_f32")
        if layout == "ijk":
            arrays = {k: np.ascontiguousarray(v.transpose(1, 2, 0)) for k, v in arrays.items()}
        st = p_dycore.make_hdiff(np.float32, "cuda", tiles=False, **options)
        kw = dict(origin=(H, H, 0), domain=CASES["hdiff_f32"][2])
        if layout == "kij":
            kw["physical_layout"] = True
        _, forms = _launched(st, lambda: st.functional(**kw)(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}))
        plan = cuda_backend.LAST_PLAN[st.name]
        assert forms == {"rows": 3} and "vector_phase" not in plan, (forms, plan)
        why = plan["declined"]["vector"]
        assert ("not J-contiguous" in why) if layout == "ijk" else why == (
            "vector=False" if options else cuda_backend.ROW_PHASE_SLOWER), plan


@pytest.mark.parametrize("case", ["hdiff_f32", "sl_step_f32"])
def test_repaired_route_on_tight_buffers(emulated, case):  # noqa: F811
    """The route the twins replaced under ``vector=True``: with
    ``repair=True`` a bounded call on the same tight buffers pads the
    fields to one 16-byte phase and runs the ``_v`` kernels on the copies,
    bit for bit against plain and against the twins."""
    make, dtype, domain, spec, scalars, *_ = CASES[case]
    kw = dict(origin=(H, H, 0), domain=domain, physical_layout=True)
    plain = _buffers(case)
    ref = make("torch").functional(**kw)(
        **{k: torch.from_numpy(v) for k, v in plain.items()}, **scalars)
    got = {}
    for route, options in (("row", {}), ("repaired", {"repair": True})):
        st = make("cuda", tiles=False, vector=True, **options)
        arrays = _buffers(case)
        got[route], forms = _launched(st, lambda: st.functional(**kw)(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}, **scalars))
        plan = cuda_backend.LAST_PLAN[st.name]
        rows = [k.name for k in st.backend.program.kernels if k.form == "rows"]
        assert forms == {"vector": len(rows)}, (forms, plan)
        assert plan["vector_phase"] == ("row" if route == "row" else "common"), plan
        assert ("repair" in plan) == (route == "repaired"), plan
        assert plan["vector_rows"] == [k + ("_vr" if route == "row" else "_v") for k in rows]
    for k, v in ref.items():
        assert torch.equal(got["repaired"][k], v), k
        assert torch.equal(got["row"][k], v), k


@pytest.mark.parametrize("options", [{}, {"vector": False}, {"vector": True}],
                         ids=["default", "vector_false", "vector_true"])
def test_only_vector_true_builds_emit_twins(options):
    """The twins are emitted, with their launch, only by a build with
    ``vector=True``, the one option that runs them; every other build's
    kernels are the vector and scalar row kernels alone."""
    st = p_dycore.make_hdiff(np.float32, "cuda", tiles=False, **options)
    rows = [k.name for k in st.backend.program.kernels if k.form == "rows"]
    src = st.backend.source
    twins = [k for k in rows if f" {k}_vr(" in src]
    assert len(rows) == 3 and all(f" {k}_v(" in src for k in rows)
    assert twins == (rows if options.get("vector") else []), twins
    assert ("vec[0] < 0" in src) == bool(options.get("vector"))
