"""Property-based field-operator test suites for the next DSL.

The next-DSL analog of the cartesian hypothesis harness
(gt4py_tpu_torch/testing/suites.py; reference:
src/gt4py/cartesian/testing/suites.py:53-383): a suite class declares an
``operator`` (field or scan operator) plus optional ranges, and the
metaclass generates one pytest method per backend that

- derives the parameter structure (dims, dtypes, scalars) from the
  operator's own typed signature -- no per-suite input plumbing,
- draws shapes, DOMAIN START OFFSETS and values with hypothesis,
- runs the numpy oracle (the executable spec) and the backend under
  test, and
- asserts dims, result domains and values agree (bitwise at f64,
  reference tolerances at f32).

Example::

    class TestLap(OperatorTestSuite):
        operator = my_lap_operator
        backends = ("torch", "cuda")
        device = "cuda"

A copy of ``gt4py_tpu.next.suites`` on the port: ``backends`` name the
port's backends (default ``"torch"`` and ``"cuda"``); the oracle's Fields
hold numpy arrays, those of the backend under test torch tensors on the
suite's ``device`` (default ``config.DEFAULT_DEVICE``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

#: f64 at the bridge fuzzers' differential contract (the JAX package's
#: tolerances: its XLA compiles with FMA fusion); f32 at the reference
#: suite tolerances
RTOL = {8: 1e-12, 4: 1e-5}
ATOL = {8: 1e-12, 4: 1e-6}


def _run_case(cls, backend: str, n_examples: int = 10):
    import torch
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    from gt4py_tpu_torch import config

    from . import backends as be_mod
    from . import type_system as ts
    from .common import Domain, Field, UnitRange

    op = cls.operator
    typed = op._decl_typed
    lo, hi = getattr(cls, "shape_range", (3, 10))
    vlo, vhi = getattr(cls, "value_range", (-10.0, 10.0))
    halo = getattr(cls, "halo", 3)
    device = config.resolve_device(getattr(cls, "device", None))

    field_params = []
    scalar_params = []
    params = typed.params
    if typed.kind == "scan_operator":
        params = params[1:]  # the carry is bound by the scan machinery
    for p in params:
        if isinstance(p.type, ts.FieldType):
            field_params.append((p.name, p.type))
        elif isinstance(p.type, ts.ScalarType):
            scalar_params.append((p.name, p.type))
        else:  # pragma: no cover
            raise TypeError(f"suite cannot derive inputs for {p.type}")
    if typed.kind == "scan_operator":
        # scalarized signature: every non-carry param may be a field over
        # the declared suite dims
        dims = cls.dims
        field_params = [
            (n, ts.FieldType(dims=tuple(dims), dtype=t)) for n, t in scalar_params
        ]
        scalar_params = []

    all_dims = []
    for _, ft in field_params:
        for d in ft.dims:
            if d not in all_dims:
                all_dims.append(d)

    @settings(
        max_examples=n_examples,
        deadline=None,
        suppress_health_check=list(HealthCheck),
    )
    @given(data=st.data())
    def case(data):
        sizes = {
            d: data.draw(st.integers(lo, hi), label=f"n_{d.value}")
            for d in all_dims
        }
        starts = {
            d: data.draw(st.integers(-4, 4), label=f"start_{d.value}")
            for d in all_dims
        }
        rng = np.random.default_rng(
            data.draw(st.integers(0, 2**31 - 1), label="seed")
        )
        args_np = []
        args_dev = []
        for name, ft in field_params:
            dt = np.dtype(ft.dtype.kind)
            shape = tuple(sizes[d] + 2 * halo for d in ft.dims)
            dom = Domain(
                tuple(ft.dims),
                tuple(
                    UnitRange(starts[d] - halo, starts[d] + sizes[d] + halo)
                    for d in ft.dims
                ),
            )
            vals = (vlo + (vhi - vlo) * rng.random(shape)).astype(dt)
            args_np.append(Field(dom, vals))
            args_dev.append(Field(dom, torch.from_numpy(vals.copy()).to(device)))
        scalars = [
            np.dtype(t.kind).type(vlo + (vhi - vlo) * rng.random())
            for _, t in scalar_params
        ]

        oracle = op.with_backend(be_mod.numpy_oracle)
        ref = oracle(*args_np, *scalars)
        under_test = op.with_backend(backend)
        got = under_test(*args_dev, *scalars)

        refs = ref if isinstance(ref, tuple) else (ref,)
        gots = got if isinstance(got, tuple) else (got,)
        assert len(refs) == len(gots)
        for r, g in zip(refs, gots):
            assert r.dims == g.dims
            assert tuple(r.domain.ranges) == tuple(g.domain.ranges), (
                f"{backend}: domains diverge {r.domain} vs {g.domain}"
            )
            items = np.dtype(r.dtype).itemsize
            np.testing.assert_allclose(
                np.asarray(g.asnumpy(), dtype=np.float64),
                np.asarray(r.asnumpy(), dtype=np.float64),
                rtol=RTOL.get(items, 1e-5),
                atol=ATOL.get(items, 1e-6),
                err_msg=f"{backend} diverges from the numpy oracle",
            )

    case()


class SuiteMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        if ns.get("operator") is None:
            return cls
        for backend in ns.get("backends", ("torch", "cuda")):

            def method(self, _b=backend, _c=cls):
                _run_case(_c, _b)

            method.__name__ = f"test_{name}_{backend}"
            setattr(cls, method.__name__, method)
        return cls


class OperatorTestSuite(metaclass=SuiteMeta):
    """Subclass with ``operator = <FieldOperator|ScanOperator>`` (fully
    annotated) and optionally ``backends``, ``device``, ``shape_range``,
    ``value_range``, ``halo``; scan suites also declare ``dims``."""

    operator = None
