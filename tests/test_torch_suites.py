"""The hypothesis suites on the port: the classes of
``tests/cartesian/test_suites.py`` declared on
``gt4py_tpu_torch.testing.StencilTestSuite`` with the port's ``"numpy"``,
``"torch"`` and ``"debug"`` backends, and those of
``tests/next/test_suites.py`` on ``gt4py_tpu_torch.next.suites.
OperatorTestSuite`` with ``numpy_oracle`` and ``torch``, each against its
validation (cartesian, rtol 1e-5 / atol 1e-8) or the numpy oracle (next,
the JAX package's tolerances), on the CPU."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch import testing as gt_testing
from gt4py_tpu_torch.next import Dims, Field, concat_where, where
from gt4py_tpu_torch.next.suites import OperatorTestSuite
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
    __INLINED,
)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these suites ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


class TestCopy(gt_testing.StencilTestSuite):
    dtypes = (np.float64, np.float32)
    domain_range = [(1, 15), (1, 15), (1, 8)]
    backends = ["numpy", "torch", "debug"]
    symbols = dict(
        field_a=gt_testing.field(in_range=(-10, 10)),
        field_b=gt_testing.field(in_range=(-10, 10)),
    )

    def definition(field_a, field_b):
        with computation(PARALLEL), interval(...):
            field_b = field_a

    def validation(field_a, field_b, domain=None, origin=None, externals=None):
        field_b[...] = field_a


class TestAvgOffsets(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(2, 12), (2, 12), (1, 6)]
    backends = ["numpy", "torch", "debug"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-10, 10), boundary=[(1, 1), (1, 1), (0, 0)]),
        out=gt_testing.field(in_range=(-10, 10)),
        w=gt_testing.parameter(in_range=(0.1, 2.0)),
    )

    def definition(inp, out, *, w):
        with computation(PARALLEL), interval(...):
            out = w * (inp[-1, 0, 0] + inp[1, 0, 0] + inp[0, -1, 0] + inp[0, 1, 0])

    def validation(inp, out, *, w, domain=None, origin=None, externals=None):
        oi, oj, _ = origin["inp"]
        dI, dJ, dK = domain
        interior = lambda di, dj: inp[
            oi + di : oi + di + dI, oj + dj : oj + dj + dJ, :
        ]
        out[
            origin["out"][0] : origin["out"][0] + dI,
            origin["out"][1] : origin["out"][1] + dJ,
        ] = w * (interior(-1, 0) + interior(1, 0) + interior(0, -1) + interior(0, 1))


class TestForwardAccumulate(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(1, 8), (1, 8), (2, 10)]
    min_k_size = 2
    backends = ["numpy", "torch", "debug"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-5, 5)),
        acc=gt_testing.field(in_range=(-5, 5)),
    )

    def definition(inp, acc):
        with computation(FORWARD):
            with interval(0, 1):
                acc = inp
            with interval(1, None):
                acc = acc[0, 0, -1] + inp

    def validation(inp, acc, domain=None, origin=None, externals=None):
        acc[...] = np.cumsum(inp, axis=2)


class TestExternalSwitch(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(1, 10), (1, 10), (1, 5)]
    backends = ["numpy", "torch", "debug"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-10, 10)),
        out=gt_testing.field(in_range=(-10, 10)),
        NEGATE=gt_testing.global_name(one_of=(True, False)),
    )

    def definition(inp, out):
        from __externals__ import NEGATE

        with computation(PARALLEL), interval(...):
            if __INLINED(NEGATE):
                out = -inp
            else:
                out = inp

    def validation(inp, out, domain=None, origin=None, externals=None):
        out[...] = -inp if externals["NEGATE"] else inp


class TestMatmul(gt_testing.StencilTestSuite):
    """`matrix @ vector` + `.T` on data-dims fields (reference:
    TestMatmul in tests/.../test_suites.py:1097; parser MatMult at
    gtscript_frontend.py:1506, unroll at defir_to_gtir.py:265-273).
    f64 only: the unrolled left-to-right multiply-add chain differs
    from einsum's reduction order at f32 (same note in the reference)."""

    dtypes = (np.float64,)
    domain_range = [(2, 6), (2, 6), (2, 4)]
    backends = ["numpy", "torch", "debug"]
    symbols = dict(
        matrix=gt_testing.field(in_range=(-10, 10), data_dims=(4, 6)),
        field_1=gt_testing.field(in_range=(-10, 10), data_dims=(6,)),
        field_2=gt_testing.field(in_range=(-10, 10), data_dims=(4,)),
    )

    def definition(matrix, field_1, field_2):
        with computation(PARALLEL):
            with interval(0, 1):
                field_2 = matrix @ field_1
            with interval(1, 2):
                field_1 = matrix.T @ field_2

    def validation(
        matrix, field_1, field_2, domain=None, origin=None, externals=None
    ):
        field_2[:, :, 0] = np.einsum(
            "ijlm,ijm->ijl", matrix[:, :, 0], field_1[:, :, 0]
        )
        field_1[:, :, 1] = np.einsum(
            "ijlm,ijl->ijm", matrix[:, :, 1], field_2[:, :, 1]
        )


# --------------------------------------------------------------------------- #
# the next DSL's operator suites
# --------------------------------------------------------------------------- #

NEXT_BACKENDS = ("numpy_oracle", "torch")

I = gtx.Dimension("I")
J = gtx.Dimension("J")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
Koff = gtx.FieldOffset("Koff", source=K, target=(K,))
F64 = Field[Dims[I, J, K], gtx.float64]
F32 = Field[Dims[I, J, K], gtx.float32]


@gtx.field_operator
def _lap(a: F64) -> F64:
    return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a


class TestLapSuite(OperatorTestSuite):
    operator = _lap
    backends = NEXT_BACKENDS


@gtx.field_operator
def _limited_flux(a: F64, b: F64, w: gtx.float64) -> F64:
    fx = a(Ioff[1]) - a
    lim = where(fx * (b(Ioff[1]) - b) > 0.0, 0.0, fx)
    return lim * w + gtx.minimum(a, b)


class TestLimiterSuite(OperatorTestSuite):
    operator = _limited_flux
    backends = NEXT_BACKENDS


@gtx.field_operator
def _pair(a: F32) -> tuple[F32, F32]:
    mid = a(Ioff[1]) + a(Ioff[-1]) - 2.0 * a
    return (mid + a, mid - a)


class TestTupleSuite(OperatorTestSuite):
    operator = _pair
    backends = NEXT_BACKENDS


@gtx.field_operator
def _bc(a: F64) -> F64:
    interior = 0.5 * (a(Koff[-1]) + a)
    return concat_where(K < 1, a * 10.0, interior)


class TestConcatWhereSuite(OperatorTestSuite):
    operator = _bc
    backends = NEXT_BACKENDS


@gtx.scan_operator(axis=K, forward=True, init=0.0)
def _damped(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
    return carry * 0.8 + x


class TestScanSuite(OperatorTestSuite):
    operator = _damped
    backends = NEXT_BACKENDS
    dims = (I, J, K)
    shape_range = (3, 8)
