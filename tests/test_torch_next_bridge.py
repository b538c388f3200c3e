"""The port's ``cuda_bridge`` against ``gt4py_tpu.next.pallas_bridge``.

- The lowering is the JAX package's: for the same operators, scans and
  programs both bridges give the same cartesian stencil IR (``repr`` of
  the lowered ``ir.Stencil``, and of every fused program instance), and
  refuse the same operators for the same reasons.
- ``with_backend("cuda")`` on CPU tensors (the kernels' plain executor)
  matches the JAX package's ``numpy_oracle`` and its ``"pallas"`` run in
  float64 at rtol 1e-12, values and result domains, with no operator
  falling back; an ineligible operator records the same fallback reasons
  as the JAX bridge.
- The generated CUDA sources of hdiff, the two programs and the
  tridiagonal scans, built by the host compiler against the emulated
  runtime of ``tests/test_torch_emulated.py``, match the plain executor.
- Seeds of ``gt4py_tpu.testing.next_fuzz.run_bridge_case``'s generated
  operators and scans run through both packages.
"""

import random
import textwrap
import warnings

import numpy as np
import pytest
import torch

import gt4py_tpu.next as jgtx
from gt4py_tpu.next import pallas_bridge as jbridge
from gt4py_tpu.next.ffront import _value_type as j_value_type
from gt4py_tpu.testing.next_fuzz import OperatorGenerator, _scan_expr

import gt4py_tpu_torch.next as pgtx
from gt4py_tpu_torch.next import cuda_bridge as pbridge
from gt4py_tpu_torch.next.ffront import _value_type as p_value_type

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_next import (
    F3,
    INTERIOR,
    JNS,
    OPERATORS,
    PNS,
    PROGRAM_FIELDS,
    PROGRAMS,
    RTOL,
    SCANS,
    assert_same,
    both,
    define,
    make_args,
    program_args,
    run_program,
)
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


#: operators the bridges lower (the rest of OPERATORS run embedded)
ELIGIBLE = ["laplacian", "hdiff", "where_scalars", "nested_where", "astype_float32",
            "float32_literals", "broadcast_ij", "ik_field", "math",
            "tuple_return", "scalar_param", "operator_call", "concat_where", "integers",
            "negation", "broadcast_scalar"]


def _lower(bridge, value_type, op, args):
    typed, _ = op._typed_for(tuple(value_type(a) for a in args))
    return bridge.lower_field_operator(typed)


def _lower_scan(bridge, op, args, pkg, value_type):
    typed = op._scan_typed([pkg.type_system.ScalarType(np.dtype(a.dtype))
                            if isinstance(a, pkg.Field) else value_type(a) for a in args])
    info = [("field", tuple(a.domain.dims), np.dtype(a.dtype)) if isinstance(a, pkg.Field)
            else ("scalar", np.dtype(type(a))) for a in args]
    return bridge.lower_scan_operator(typed, axis=op.axis, forward=op.forward, init=op.init,
                                      arg_info=info)


@pytest.mark.parametrize("name", list(OPERATORS))
def test_lowering_gives_the_same_stencil_ir(name):
    src, spec = OPERATORS[name]
    jns, pns = both(src)
    outcome = []
    for bridge, vt, ns, pkg, kind in ((jbridge, j_value_type, jns, jgtx, "numpy"),
                                      (pbridge, p_value_type, pns, pgtx, "torch")):
        args = make_args(spec, ns, pkg, 0, kind)
        try:
            plan = _lower(bridge, vt, ns["op"], args)
            outcome.append(("lowered", repr(plan.stencil), plan.axis_of, plan.is_tuple))
        except bridge.Ineligible as ex:
            outcome.append(("ineligible", str(ex)))
    assert outcome[1] == outcome[0]
    assert (outcome[0][0] == "lowered") == (name in ELIGIBLE)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_lowering_gives_the_same_stencil_ir(name):
    src, spec = SCANS[name]
    jns, pns = both(src)
    jplan = _lower_scan(jbridge, jns["op"], make_args(spec, jns, jgtx, 0, "numpy"), jgtx,
                        j_value_type)
    pplan = _lower_scan(pbridge, pns["op"], make_args(spec, pns, pgtx, 0, "torch"), pgtx,
                        p_value_type)
    assert repr(pplan.stencil) == repr(jplan.stencil)
    assert pplan.out_names == jplan.out_names and pplan.is_tuple == jplan.is_tuple


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_lowering_gives_the_same_fused_stencils(name):
    jns, pns = both(PROGRAMS[name])
    found = []
    for bridge, ns, pkg, kind, vt in ((jbridge, jns, jgtx, "numpy", j_value_type),
                                      (pbridge, pns, pgtx, "torch", p_value_type)):
        prog = ns["prog"]
        args = program_args(ns, pkg, kind,
                            layout=INTERIOR if name == "mixed_prog" else PROGRAM_FIELDS)
        typed = prog._typed_for(tuple(vt(a) for a in args))
        env = {p.name: a for p, a in zip(typed.params, args)}
        sched = bridge.lower_program(typed)
        items = []
        for kind_, payload in sched.items:
            if kind_ == "fused":
                inst = bridge.prepare_program_plan(payload, env)
                items.append(("fused", repr(inst.analysis.stencil), inst.domain,
                              tuple(inst.starts)))
            else:
                items.append(("interp", type(payload).__name__))
        found.append(items)
    assert found[1] == found[0]
    assert any(k == "fused" for k, *_ in found[0])


# --------------------------------------------------------------------- #
# values: cuda on CPU tensors against numpy_oracle and pallas
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("jbackend", ["numpy_oracle", "pallas"])
@pytest.mark.parametrize("name", ELIGIBLE)
def test_field_operator_cuda_vs_jax(name, jbackend):
    src, spec = OPERATORS[name]
    jns, pns = both(src)
    kind = "numpy" if jbackend == "numpy_oracle" else "jax"
    ref = jns["op"].with_backend(jbackend)(*make_args(spec, jns, jgtx, 3, kind))
    cur = pbridge.FALLBACK_EVENTS.cursor()
    op = pns["op"].with_backend("cuda")
    got = op(*make_args(spec, pns, pgtx, 3, "torch"))
    assert pbridge.FALLBACK_EVENTS.since(cur) == []
    assert any(p is not None for p in op.__dict__["_bridge_plans"].values())
    assert_same(ref, got, RTOL[np.float32] if "F32" in src else RTOL[np.float64])


@pytest.mark.parametrize("jbackend", ["numpy_oracle", "pallas"])
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_cuda_vs_jax(name, jbackend):
    src, spec = SCANS[name]
    jns, pns = both(src)
    kind = "numpy" if jbackend == "numpy_oracle" else "jax"
    ref = jns["op"].with_backend(jbackend)(*make_args(spec, jns, jgtx, 3, kind))
    cur = pbridge.FALLBACK_EVENTS.cursor()
    op = pns["op"].with_backend("cuda")
    got = op(*make_args(spec, pns, pgtx, 3, "torch"))
    assert pbridge.FALLBACK_EVENTS.since(cur) == []
    assert any(p is not None for p in op.__dict__["_scan_bridge_plans"].values())
    assert_same(ref, got, RTOL[np.float64])


@pytest.mark.parametrize("fusion", [True, False], ids=["fused", "statementwise"])
@pytest.mark.parametrize("jbackend", ["numpy_oracle", "pallas"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_cuda_vs_jax(name, jbackend, fusion):
    cur = pbridge.FALLBACK_EVENTS.cursor()
    jargs, pargs, prog = run_program(name, jbackend, "cuda", fusion)
    assert pbridge.FALLBACK_EVENTS.since(cur) == []
    for j, p in zip(jargs, pargs):
        assert_same(j, p, RTOL[np.float64])
    assert pbridge.kernels_of(prog)
    fused = any(s is not None and any(k == "fused" for k, _ in s.items)
                for s in prog.__dict__.get("_prog_bridge_plans", {}).values())
    assert fused == fusion


INELIGIBLE = {
    "differing_tuple_extents": ("""
        @field_operator
        def op(a: FT, b: FT):
            u = a + b
            return u(Ioff[1]) - u, u(Joff[1]) + u
        """, [F3, F3]),
    "concat_where_in_i": ("""
        @field_operator
        def op(a: FT, b: FT) -> FT:
            return concat_where(I < 3, a, b)
        """, [F3, F3]),
}


@pytest.mark.parametrize("name", list(INELIGIBLE))
def test_ineligible_operators_record_the_same_fallbacks(name):
    src, spec = INELIGIBLE[name]
    jns, pns = both(src)
    jcur, pcur = jbridge.FALLBACK_EVENTS.cursor(), pbridge.FALLBACK_EVENTS.cursor()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # each package warns once per reason
        ref = jns["op"].with_backend("pallas")(*make_args(spec, jns, jgtx, 1, "jax"))
        got = pns["op"].with_backend("cuda")(*make_args(spec, pns, pgtx, 1, "torch"))
    jev, pev = jbridge.FALLBACK_EVENTS.since(jcur), pbridge.FALLBACK_EVENTS.since(pcur)
    assert pev and pev == jev
    assert_same(ref, got, RTOL[np.float64])


# --------------------------------------------------------------------- #
# the generated sources on the host compiler
# --------------------------------------------------------------------- #


def _launched(obj):
    return sum(b.launches for b in pbridge.kernels_of(obj))


@pytest.mark.parametrize("name", ["hdiff", "tuple_return", "concat_where", "ik_field",
                                  "broadcast_ij"])
def test_operator_kernels_emulated_vs_plain(emulated, name):  # noqa: F811
    src, spec = OPERATORS[name]
    _, pns = both(src)
    plain = pns["op"].with_backend("torch")(*make_args(spec, pns, pgtx, 4, "torch"))
    op = pns["op"].with_backend("cuda")
    got = op(*make_args(spec, pns, pgtx, 4, "torch"))
    assert _launched(op) == 1
    assert_same(plain, got, RTOL[np.float64])


@pytest.mark.parametrize("name", ["tuple_carry", "decay_backward"])
def test_scan_kernels_emulated_vs_plain(emulated, name):  # noqa: F811
    src, spec = SCANS[name]
    _, pns = both(src)
    plain = pns["op"].with_backend("torch")(*make_args(spec, pns, pgtx, 4, "torch"))
    op = pns["op"].with_backend("cuda")
    got = op(*make_args(spec, pns, pgtx, 4, "torch"))
    assert _launched(op) == 1
    assert_same(plain, got, RTOL[np.float64])


@pytest.mark.parametrize("fusion", [True, False], ids=["fused", "statementwise"])
@pytest.mark.parametrize("name", ["hdiff_prog", "mixed_prog"])
def test_program_kernels_emulated_vs_plain(emulated, name, fusion):  # noqa: F811
    _, plain, _ = run_program(name, "numpy_oracle", "torch", fusion)
    _, got, prog = run_program(name, "numpy_oracle", "cuda", fusion)
    assert _launched(prog) >= (1 if fusion else 3)
    for p, g in zip(plain, got):
        assert_same(p, g, RTOL[np.float64])


# --------------------------------------------------------------------- #
# next_fuzz.run_bridge_case's generated operators, through both packages
# --------------------------------------------------------------------- #


def bridge_case(seed):
    """The source, argument spec and scan settings that ``run_bridge_case``
    draws for ``seed`` (its operator and scan families; the concat_where
    family draws the operator family's sources here)."""
    rng = random.Random(seed ^ 0x5EED)
    if rng.random() < 0.4:
        arity = rng.choice([1, 2])
        cnames = ["carry"] if arity == 1 else ["carry[0]", "carry[1]"]
        names = cnames + ["x", "g", "w"]
        if arity == 1:
            src = ("@scan_operator(axis=K, forward=FWD, init=INIT)\n"
                   "def op(carry: float64, x: float64, g: float64, w: float64) -> float64:\n"
                   f"    return {_scan_expr(rng, names)}\n")
            init = round(rng.uniform(-1, 1), 3)
        else:
            e0, e1 = _scan_expr(rng, names), _scan_expr(rng, names)
            src = ("@scan_operator(axis=K, forward=FWD, init=INIT)\n"
                   "def op(carry: tuple[float64, float64], x: float64, g: float64, w: float64):\n"
                   f"    t = {_scan_expr(rng, names)}\n"
                   f"    return ({e0} + 0.0 * t, {e1} + 0.0 * t)\n")
            init = (round(rng.uniform(-1, 1), 3), round(rng.uniform(-1, 1), 3))
        forward = rng.random() < 0.5
        g_dims = "IJK" if rng.random() < 0.5 else "IJ"
        src = src.replace("FWD", repr(forward)).replace("INIT", repr(init))
        return src, [F3, (g_dims, np.float64, 0.0), np.float64(0.37)]
    rng.random()  # the concat_where draw
    gen = OperatorGenerator(rng)
    gen.field_names = {"a", "b"}
    names = ["a", "b"]
    body = []
    helper = ("@field_operator\ndef helper(x: FIJ, w: float64) -> FIJ:\n"
              f"    return ({_scan_expr(rng, ['x', 'w'])}) + 0.0 * x\n")
    for i in range(rng.randint(1, 3)):
        t = f"t{i}"
        if rng.random() < 0.35:
            arg = gen._expr(names)
            if not gen._is_field_expr(arg):
                arg = f"({arg}) + 0.0 * a"
            body.append(f"{t} = helper({arg}, s)")
            gen.field_names.add(t)
        else:
            e = gen._expr(names)
            body.append(f"{t} = {e}")
            if gen._is_field_expr(e):
                gen.field_names.add(t)
        names.append(t)
    ret = gen._expr(names)
    if not gen._is_field_expr(ret):
        ret = f"({ret}) + 0.0 * a"
    src = helper + "@field_operator\ndef op(a: FIJ, b: FIJ, s: float64):\n" + textwrap.indent(
        "\n".join(body + [f"return {ret}"]), "    ")
    return src, [("IJ", np.float64, 0.0), ("IJ", np.float64, 0.0), np.float64(-0.41)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
def test_bridge_fuzz_seed_cuda_vs_oracle(seed):
    src, spec = bridge_case(seed)
    jenv, penv = define(src, JNS), define(src, PNS)
    ref = jenv["op"].with_backend("numpy_oracle")(*make_args(spec, jenv, jgtx, seed, "numpy"))
    got = penv["op"].with_backend("cuda")(*make_args(spec, penv, pgtx, seed, "torch"))
    assert_same(ref, got, RTOL[np.float64])


BENCH_CASES = ["hdiff", "hdiff_kcontig", "hdiff_prog_fused", "hdiff_prog_statementwise",
               "mixed_prog_fused", "mixed_prog_statementwise", "tridiag"]


@pytest.mark.parametrize("name", BENCH_CASES)
def test_bench_cases_emulated_vs_embedded(emulated, name):  # noqa: F811
    """The chip check's phase 7 on the CPU: bench.py's next configurations
    (small), their kernels built by the host compiler, against the
    embedded torch path -- every planned kernel launched, none falling
    back, equal values."""
    from gt4py_tpu_torch.next.testing import bench_cases, program_fusion

    cur = pbridge.FALLBACK_EVENTS.cursor()
    cases = bench_cases(np.float64, (12, 9, 4), "cpu")
    case = cases[name]
    with program_fusion(case["fusion"]):
        case["kernels"]()
        got = case["run"]("cuda")
        ref = (cases["hdiff"] if name == "hdiff_kcontig" else case)["run"]("torch")
    counts = [k.launches for obj in case["objs"] for k in pbridge.kernels_of(obj)]
    assert counts and min(counts) >= 1
    assert pbridge.FALLBACK_EVENTS.since(cur) == []
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_out_and_domain_call_vs_oracle(backend):
    """``op(..., out=, domain=)``: the compiled path restricts the kernel's
    domain up front, the embedded one writes a slice; both equal the JAX
    oracle, and the rest of ``out`` keeps its values."""
    src, spec = OPERATORS["hdiff"]
    jns, pns = both(src)
    res = []
    for ns, pkg, kind, be in ((jns, jgtx, "numpy", "numpy_oracle"), (pns, pgtx, "torch", backend)):
        args = make_args(spec, ns, pkg, 6, kind)
        out = make_args([("IJK", np.float64, 3.0)], ns, pkg, 7, kind)[0]
        dom = pkg.common.Domain((ns["I"], ns["J"], ns["K"]), tuple(
            pkg.common.UnitRange(a, b) for a, b in ((3, 6), (2, 5), (1, 4))))
        ns["op"].with_backend(be)(*args, out=out, domain=dom)
        res.append(out)
    assert_same(res[0], res[1], RTOL[np.float64])
