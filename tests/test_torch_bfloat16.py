"""bfloat16 in the port, held to the JAX package's bfloat16 (ml_dtypes).

The port's dtype token is ``core.definitions.BFLOAT16`` (no ml_dtypes on
the card's machine); tensors are ``torch.bfloat16``.  The counterparts of
``tests/cartesian/test_bfloat16.py`` and ``tests/next/test_bfloat16.py``:
promotion, storage-format semantics (``passes.widen_f16_compute``: every
statement computes in float32 and rounds once per 16-bit store), argument
validation, and the plain executor (``"torch"``, and ``"cuda"`` on CPU
tensors) against the JAX package's numpy oracle, bit for bit.  The
generated kernels are held to the plain executor in
``tests/test_torch_emulated.py`` (g++) and ``tests/test_torch_cuda.py``
(the card).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import gt4py_tpu.next as jgtx
from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    erf,
    exp,
    gamma,
    interval,
    mod,
    sin,
    sqrt,
)

import gt4py_tpu_torch.next as pgtx
from gt4py_tpu_torch import config, storage
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.analysis import is_float_dtype, promote_dtypes
from gt4py_tpu_torch.cartesian.stencil_object import ArgumentError
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import BFLOAT16
from gt4py_tpu_torch.next import type_system as p_ts
from gt4py_tpu_torch.next.frontend import FieldViewError

from .test_torch_frontend import to_port
from .test_torch_next import define, namespace


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


ML_BF16 = np.dtype(ml_dtypes.bfloat16)
FieldBF = jgts.Field[jgts.bfloat16]
Field32 = jgts.Field[np.float32]
BACKENDS = ["torch", "cuda"]


def _mk(seed, shape, dtype=ml_dtypes.bfloat16):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _port_def(fn):
    """A definition written for the JAX package, on the port: ``to_port``,
    with the JAX package's bfloat16 mapped to the port's token."""
    new = to_port(fn)

    def fix(v):
        if isinstance(v, pgts._FieldDescriptor) and np.dtype(v.dtype) == ML_BF16:
            return pgts._FieldDescriptor(BFLOAT16, v.axes, v.data_dims)
        return pgts.bfloat16 if v is jgts.bfloat16 else v

    for k, v in list(new.__globals__.items()):
        new.__globals__[k] = fix(v)
    new.__annotations__ = {k: fix(v) for k, v in new.__annotations__.items()}
    return new


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor of the
    same values and dtype."""
    if a.dtype == ML_BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(defn, fields, scalars=None, **kw):
    """The JAX package's numpy backend on copies of ``fields``, as float64."""
    st = jgts.stencil(backend="numpy", definition=defn, rebuild=True)
    arrs = {k: v.copy() for k, v in fields.items()}
    st(**arrs, **(scalars or {}), **kw)
    return {k: np.asarray(v, dtype=np.float64) for k, v in arrs.items()}


def _port(defn, backend, fields, scalars=None, **kw):
    """The port's ``backend`` on the same inputs, as float64."""
    st = pgts.stencil(backend=backend, definition=_port_def(defn), rebuild=True)
    ts = {k: _to_tensor(v) for k, v in fields.items()}
    st(**ts, **(scalars or {}), **kw)
    for k, t in ts.items():
        assert t.dtype == dtypes.to_torch(_port_dtype(fields[k].dtype)), k
    return {k: t.double().numpy() for k, t in ts.items()}


def _port_dtype(dt):
    return BFLOAT16 if np.dtype(dt) == ML_BF16 else np.dtype(dt)


# --------------------------------------------------------------------------- #
# the dtype
# --------------------------------------------------------------------------- #


def test_promote_dtypes_bfloat16():
    assert promote_dtypes(BFLOAT16, np.dtype(np.float32)) == np.dtype(np.float32)
    assert promote_dtypes(BFLOAT16, np.dtype(np.float64)) == np.dtype(np.float64)
    assert promote_dtypes(BFLOAT16, np.dtype(np.int32)) == BFLOAT16
    assert promote_dtypes(BFLOAT16, BFLOAT16) == BFLOAT16
    assert promote_dtypes(BFLOAT16, np.dtype(np.float16)) == np.dtype(np.float32)
    assert promote_dtypes(np.dtype(np.float16), BFLOAT16) == np.dtype(np.float32)


def test_token():
    """A 2-byte dtype of numpy kind 'V' (as ml_dtypes.bfloat16's), a float
    for the language layers, and torch.bfloat16 for tensors."""
    assert BFLOAT16.kind == "V" and BFLOAT16.itemsize == 2
    assert pgts.bfloat16 is BFLOAT16 and pgtx.bfloat16 is BFLOAT16
    assert is_float_dtype(BFLOAT16) and is_float_dtype(np.float32)
    assert not is_float_dtype(np.int32) and not is_float_dtype(np.bool_)
    assert BFLOAT16 != np.dtype("V2")
    assert dtypes.to_torch(BFLOAT16) == torch.bfloat16
    assert dtypes.to_numpy(torch.bfloat16) == BFLOAT16


def test_cast_from_float64_as_the_oracle():
    """float64 -> bfloat16 as the JAX package's oracle (ml_dtypes) casts:
    through float32, like torch.  Every non-NaN value agrees, the ties that
    the two roundings decide differently included."""
    rng = np.random.default_rng(5)
    ties = np.float32(rng.normal(0, 10, 2000)).astype(ML_BF16).astype(np.float64)
    x = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000),
                        ties * (1 + 2 ** -8 + 2 ** -30), ties * (1 + 2 ** -8),
                        [0.0, -0.0, np.inf, -np.inf, 3.4e38, 1e-45]])
    with np.errstate(over="ignore"):
        ref = x.astype(ML_BF16).astype(np.float32)
    got = dtypes.cast(torch.from_numpy(x), BFLOAT16).float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert dtypes.scalar_value(0.1, BFLOAT16) == float(ml_dtypes.bfloat16(0.1))


# --------------------------------------------------------------------------- #
# cartesian stencils: the plain executor against the numpy oracle
# --------------------------------------------------------------------------- #


def defn_arith(inp: FieldBF, out: FieldBF, *, w: jgts.bfloat16):
    with computation(PARALLEL), interval(...):
        lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        out = inp - w * (lap - 4.0 * inp)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_arith_bitwise(backend):
    """The scalar ``w`` is given as a Python float: both round it to
    bfloat16 on entry."""
    fields = {"inp": _mk(0, (10, 10, 4)), "out": np.zeros((10, 10, 4), dtype=ML_BF16)}
    kw = dict(origin=(1, 1, 0), domain=(8, 8, 4))
    ora = _oracle(defn_arith, fields, {"w": ml_dtypes.bfloat16(0.1)}, **kw)
    res = _port(defn_arith, backend, fields, {"w": 0.1}, **kw)
    np.testing.assert_array_equal(res["out"], ora["out"])
    assert np.abs(ora["out"]).max() > 0


def defn_scan(inp: FieldBF, out: FieldBF):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp


def defn_backward(inp: FieldBF, out: FieldBF):
    with computation(BACKWARD):
        with interval(-1, None):
            out = inp
        with interval(0, -1):
            out = out[0, 0, 1] * 0.5 + inp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("defn", [defn_scan, defn_backward])
def test_bf16_scan_bitwise(backend, defn):
    fields = {"inp": _mk(1, (6, 6, 8)), "out": np.zeros((6, 6, 8), dtype=ML_BF16)}
    np.testing.assert_array_equal(_port(defn, backend, fields)["out"],
                                  _oracle(defn, fields)["out"])


def defn_natives(inp: FieldBF, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = erf(inp) + sin(inp) + sqrt(inp) + exp(inp) + mod(inp, 1.5) + gamma(inp)


def test_bf16_transcendentals_few_ulps():
    """The oracle computes transcendentals in float64 (scipy) and rounds
    once; torch computes them in float32: a couple of bfloat16 ulps (2^-8
    relative each), the JAX package's bound for its own XLA path."""
    fields = {"inp": (0.5 + _mk(2, (8, 8, 3)).astype(np.float64)).astype(ML_BF16),
              "out": np.zeros((8, 8, 3), dtype=ML_BF16)}
    np.testing.assert_allclose(_port(defn_natives, "torch", fields)["out"],
                               _oracle(defn_natives, fields)["out"], rtol=2 ** -6, atol=2 ** -6)


def defn_mod(inp: FieldBF, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = mod(inp, 1.5)


def test_bf16_mod_rounds_once_into_bfloat16():
    """``mod`` of a bfloat16 field computes at higher precision and the
    store rounds the result once into the bfloat16 field."""
    inp = _mk(3, (4, 4, 2))
    fields = {"inp": inp, "out": np.zeros_like(inp)}
    res = _port(defn_mod, "torch", fields)
    expect = np.mod(inp.astype(np.float64), 1.5).astype(ML_BF16).astype(np.float64)
    np.testing.assert_array_equal(res["out"], expect)
    np.testing.assert_array_equal(res["out"], _oracle(defn_mod, fields)["out"])


def defn_mixed(inp: FieldBF, coef: Field32, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = inp * coef + 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_mixed_precision_bitwise(backend):
    fields = {"inp": _mk(4, (8, 8, 3)), "coef": _mk(5, (8, 8, 3), np.float32),
              "out": np.zeros((8, 8, 3), dtype=ML_BF16)}
    np.testing.assert_array_equal(_port(defn_mixed, backend, fields)["out"],
                                  _oracle(defn_mixed, fields)["out"])


def test_bf16_storage_and_arg_validation():
    z = storage.zeros((4, 4, 2), dtype=pgts.bfloat16, device="cpu")
    assert z.dtype == BFLOAT16 and z.data.dtype == torch.bfloat16
    f = storage.from_array(np.full((4, 4, 2), 0.1), dtype=pgts.bfloat16, device="cpu")
    assert f.dtype == BFLOAT16
    assert f.to_numpy().dtype == np.float32
    np.testing.assert_array_equal(f.to_numpy(), np.full((4, 4, 2), 0.1).astype(ML_BF16)
                                  .astype(np.float32))

    st = pgts.stencil(backend="torch", definition=_port_def(defn_scan), rebuild=True)
    with pytest.raises(ArgumentError, match="bfloat16"):
        st(torch.zeros((4, 4, 2)), torch.zeros((4, 4, 2), dtype=torch.bfloat16))


def test_dtypes_mapping_to_bfloat16():
    """``dtypes={float: bfloat16}`` rebinds generic ``float`` annotations
    at build time."""

    def defn(inp: pgts.Field[float], out: pgts.Field[float]):
        with computation(PARALLEL), interval(...):
            out = inp * 2.0

    st = pgts.stencil(backend="torch", definition=defn, dtypes={float: pgts.bfloat16})
    inp = _mk(9, (4, 4, 2))
    out = torch.zeros((4, 4, 2), dtype=torch.bfloat16)
    st(_to_tensor(inp), out)
    np.testing.assert_array_equal(
        out.float().numpy(), (inp.astype(np.float32) * 2.0).astype(ML_BF16).astype(np.float32))


def chain(inp: FieldBF, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = ((inp + 0.001) + 0.001) + 0.001


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_statement_accumulates_in_f32(backend):
    """Storage-format semantics: the statement computes in float32 and the
    store rounds once (not the per-operation bfloat16 chain)."""
    inp = _mk(7, (4, 4, 2))
    expect = (((inp.astype(np.float32) + np.float32(0.001)) + np.float32(0.001))
              + np.float32(0.001)).astype(ML_BF16)
    per_op = ((inp + ml_dtypes.bfloat16(0.001)) + ml_dtypes.bfloat16(0.001)) \
        + ml_dtypes.bfloat16(0.001)
    assert not np.array_equal(expect.astype(np.float64), per_op.astype(np.float64))
    res = _port(chain, backend, {"inp": inp, "out": np.zeros_like(inp)})
    np.testing.assert_array_equal(res["out"], expect.astype(np.float64))


def defn_temp(inp: FieldBF, out: FieldBF):
    with computation(PARALLEL), interval(...):
        t = inp * 1.001
        out = t + inp


def test_bf16_temporary_is_f32():
    """A temporary of a bfloat16 expression holds float32 (no rounding
    until the store), as in the oracle."""
    inp = _mk(8, (4, 4, 2))
    fields = {"inp": inp, "out": np.zeros_like(inp)}
    expect = (inp.astype(np.float32) * np.float32(1.001) + inp.astype(np.float32)).astype(ML_BF16)
    res = _port(defn_temp, "torch", fields)
    np.testing.assert_array_equal(res["out"], expect.astype(np.float64))
    np.testing.assert_array_equal(res["out"], _oracle(defn_temp, fields)["out"])


def test_bf16_kernel_source():
    """The generated CUDA stores bfloat16 as ``__nv_bfloat16`` and computes
    in float."""
    st = pgts.stencil(backend="cuda", definition=_port_def(defn_arith), rebuild=True)
    src = st.backend.source
    assert "gt::Field<__nv_bfloat16> f_inp" in src
    assert "__bfloat162float(" in src and "__float2bfloat16_rn(" in src
    assert "const float s_w" in src


# --------------------------------------------------------------------------- #
# the next DSL: the embedded torch path against the JAX package
# --------------------------------------------------------------------------- #


def _ns(pkg):
    ns = namespace(pkg)
    ns.update(bfloat16=pkg.bfloat16, BF=pkg.Field[pkg.Dims[ns["I"], ns["J"]], pkg.bfloat16],
              BFK=pkg.Field[pkg.Dims[ns["K"]], pkg.bfloat16])
    return ns


JNS, PNS = _ns(jgtx), _ns(pgtx)

NEXT_OPS = {
    "mul_add": ("""
        @field_operator
        def op(a: BF, b: BF) -> BF:
            return a * b + a
        """, 2),
    "literals": ("""
        @field_operator
        def op(a: BF) -> BF:
            return a * 0.1 + 0.5
        """, 1),
    "weak_where": ("""
        @field_operator
        def op(a: BF) -> BF:
            sel = where(a > 0.5, 1.0, 0.3)
            return a * sel
        """, 1),
    "astype": ("""
        @field_operator
        def op(a: Field[Dims[I, J], float32]) -> BF:
            return astype(a * 3.0, bfloat16)
        """, 1),
}


def _next_args(name, n):
    rng = np.random.default_rng(len(name))
    arrs = [rng.random((5, 6)).astype(np.float32) for _ in range(n)]
    bf = name != "astype"
    j = [jgtx.as_field((JNS["I"], JNS["J"]), a.astype(ML_BF16) if bf else a) for a in arrs]
    p = [pgtx.as_field((PNS["I"], PNS["J"]), torch.from_numpy(a).to(torch.bfloat16) if bf
                       else torch.from_numpy(a), device="cpu") for a in arrs]
    return j, p


@pytest.mark.parametrize("name", list(NEXT_OPS))
def test_next_bf16_operator_bitwise(name):
    """bfloat16 operators compute each operation in float32 and round, as
    ml_dtypes does; weak literals round to bfloat16 first."""
    src, n = NEXT_OPS[name]
    jop, pop = define(src, JNS)["op"], define(src, PNS)["op"]
    jargs, pargs = _next_args(name, n)
    ref, got = jop(*jargs), pop(*pargs)
    assert np.dtype(ref.dtype) == ML_BF16
    assert got.dtype == BFLOAT16 and got.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(ref.data).astype(np.float32))


@pytest.mark.parametrize("name", ["mul_add", "literals"])
def test_next_bf16_operator_on_cuda_backend(name):
    """Lowered onto the cartesian ``"cuda"`` backend (its plain executor on
    CPU tensors, the kernels' semantics): the bridge keeps the DSL's
    per-operation rounding, so the result equals the embedded path's."""
    from gt4py_tpu_torch.next import cuda_bridge

    src, n = NEXT_OPS[name]
    pop = define(src, PNS)["op"]
    _, pargs = _next_args(name, n)
    cursor = cuda_bridge.FALLBACK_EVENTS.cursor()
    got = pop.with_backend("cuda")(*pargs)
    assert not cuda_bridge.FALLBACK_EVENTS.since(cursor)
    assert got.data.dtype == torch.bfloat16
    torch.testing.assert_close(got.data, pop(*pargs).data, rtol=0, atol=0)


def test_next_bf16_is_arithmetic():
    t = p_ts.ScalarType(BFLOAT16)
    assert p_ts.is_arithmetic(t)
    assert not p_ts.is_logical(t)
    assert not p_ts.is_integral(t)


def test_next_bf16_mixed_concrete_dtypes_rejected():
    with pytest.raises(FieldViewError, match="could not promote"):
        define("""
            @field_operator
            def bad(a: BF, b: Field[Dims[I, J], float32]) -> BF:
                return a + b
            """, PNS)


def test_next_bf16_scan_bitwise():
    """A bfloat16 carry accumulates in bfloat16, level by level, as in the
    JAX package (a weak ``0.0`` init adapts to the carry's dtype)."""
    src = """
        @scan_operator(axis=K, forward=True, init=0.0)
        def cumsum(carry: bfloat16, x: bfloat16) -> bfloat16:
            return carry + x
        """
    x = _mk(3, (8,))
    ref = define(src, JNS)["cumsum"](jgtx.as_field((JNS["K"],), x))
    got = define(src, PNS)["cumsum"](pgtx.as_field((PNS["K"],), _to_tensor(x), device="cpu"))
    assert got.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(ref.data).astype(np.float32))
