"""Property-based stencil test suites.

Re-design of the reference's hypothesis-driven ``StencilTestSuite``
(reference: src/gt4py/cartesian/testing/suites.py:53-383 and
input_strategies.py): a suite class declares dtypes, a domain range,
backends, symbol strategies, a stencil ``definition`` and a pure-numpy
``validation``; the metaclass generates pytest methods that build the
stencil for each backend, run it on hypothesis-generated inputs, and
compare against the validation function (RTOL=1e-5/ATOL=1e-8 as in
suites.py:42-44).

A copy of ``gt4py_tpu.testing.suites`` on the port: ``backends`` name the
port's backends (default ``"numpy"`` and ``"torch"``), the inputs are
numpy arrays on the host, or tensors on the suite's ``device`` (default
``config.DEFAULT_DEVICE``) for the backends that run there, and results
come back to the host for the comparison.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

RTOL = 1e-05
ATOL = 1e-08


@dataclass
class FieldSpec:
    in_range: Tuple[float, float] = (-10.0, 10.0)
    boundary: Sequence[Tuple[int, int]] = ((0, 0), (0, 0), (0, 0))
    axes: str = "IJK"
    data_dims: Tuple[int, ...] = ()
    dtype: Optional[Any] = None


@dataclass
class ParameterSpec:
    in_range: Tuple[float, float] = (-10.0, 10.0)
    dtype: Optional[Any] = None


@dataclass
class GlobalSpec:
    one_of: Sequence[Any] = (True, False)


@dataclass
class NoneSpec:
    pass


def field(in_range=(-10.0, 10.0), boundary=((0, 0), (0, 0), (0, 0)), axes="IJK",
          data_dims=(), dtype=None) -> FieldSpec:
    return FieldSpec(tuple(in_range), tuple(boundary), axes, tuple(data_dims), dtype)


def parameter(in_range=(-10.0, 10.0), dtype=None) -> ParameterSpec:
    return ParameterSpec(tuple(in_range), dtype)


def global_name(one_of) -> GlobalSpec:
    return GlobalSpec(tuple(one_of))


def none() -> NoneSpec:
    return NoneSpec()


class SuiteMeta(type):
    """Generates parametrized pytest methods from the suite declaration."""

    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        if not bases:  # the StencilTestSuite base itself
            return cls

        required = ("definition", "validation", "symbols", "domain_range")
        for r in required:
            if r not in namespace and not hasattr(cls, r):
                raise TypeError(f"StencilTestSuite '{name}' missing '{r}'")

        backends = getattr(cls, "backends", ["numpy", "torch"])
        dtypes = getattr(cls, "dtypes", (np.float64,))
        if isinstance(dtypes, dict):
            dtype_list = sorted({np.dtype(d).name for ds in dtypes.values() for d in ds})
        else:
            dtype_list = [np.dtype(d).name for d in dtypes]

        import pytest

        @pytest.mark.parametrize("backend", backends)
        @pytest.mark.parametrize("dtype_name", dtype_list)
        def test_stencil_vs_validation(self, backend, dtype_name):
            _run_suite_case(type(self), backend, np.dtype(dtype_name))

        cls.test_stencil_vs_validation = test_stencil_vs_validation
        return cls


class StencilTestSuite(metaclass=SuiteMeta):
    """Base class; subclasses declare the suite (see module docstring)."""


def _field_dtype(cls, spec, default_dtype):
    if spec.dtype is not None:
        return np.dtype(spec.dtype)
    return default_dtype


def _run_suite_case(cls, backend: str, dtype: np.dtype, n_examples: int = 8):
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    import torch

    from gt4py_tpu_torch import config
    from gt4py_tpu_torch.cartesian import gtscript

    symbols: Dict[str, Any] = cls.symbols
    domain_range = cls.domain_range

    field_specs = {k: v for k, v in symbols.items() if isinstance(v, FieldSpec)}
    param_specs = {k: v for k, v in symbols.items() if isinstance(v, ParameterSpec)}
    global_specs = {k: v for k, v in symbols.items() if isinstance(v, GlobalSpec)}

    # build the stencil definition with annotations applied
    definition = cls.definition
    annotations = {}
    for fname, spec in field_specs.items():
        fdtype = _field_dtype(cls, spec, dtype)
        axes = tuple(getattr(gtscript, ax) for ax in spec.axes)
        if spec.data_dims:
            annotations[fname] = gtscript.Field[axes, (fdtype.type, spec.data_dims)]
        else:
            annotations[fname] = gtscript.Field[axes, fdtype.type]
    for pname, spec in param_specs.items():
        annotations[pname] = (spec.dtype or dtype).type if hasattr(
            spec.dtype or dtype, "type"
        ) else (spec.dtype or dtype)
    definition.__annotations__ = annotations

    globals_strategy = {
        k: st.sampled_from(list(v.one_of)) for k, v in global_specs.items()
    }
    domain_strategy = st.tuples(
        *(st.integers(lo, hi) for (lo, hi) in domain_range)
    )

    @settings(
        max_examples=n_examples,
        deadline=None,
        suppress_health_check=[HealthCheck.data_too_large, HealthCheck.too_slow],
    )
    @given(data=st.data())
    def run_one(data):
        externals = {k: data.draw(s, label=k) for k, s in globals_strategy.items()}
        domain = data.draw(domain_strategy, label="domain")
        min_k = getattr(cls, "min_k_size", 1)
        if domain[2] < min_k:
            domain = (domain[0], domain[1], min_k)

        stencil = gtscript.stencil(
            backend=backend,
            definition=definition,
            externals=externals,
            name=f"{cls.__name__}_{backend}_{dtype.name}",
            rebuild=False,
        )

        arrays: Dict[str, np.ndarray] = {}
        origins: Dict[str, Tuple[int, ...]] = {}
        scalars: Dict[str, Any] = {}
        rng_seed = data.draw(st.integers(0, 2**31 - 1), label="seed")
        rng = np.random.default_rng(rng_seed)
        for fname, spec in field_specs.items():
            fdtype = _field_dtype(cls, spec, dtype)
            axes_sizes = {"I": domain[0], "J": domain[1], "K": domain[2]}
            shape = []
            origin = []
            for ax, (lo_b, hi_b) in zip(spec.axes, spec.boundary):
                shape.append(axes_sizes[ax] + lo_b + hi_b)
                origin.append(lo_b)
            shape += list(spec.data_dims)
            lo, hi = spec.in_range
            if np.dtype(fdtype).kind == "b":
                arr = rng.integers(0, 2, size=shape).astype(bool)
            elif np.dtype(fdtype).kind in "iu":
                arr = rng.integers(int(lo), int(hi) + 1, size=shape).astype(fdtype)
            else:
                arr = (lo + (hi - lo) * rng.random(shape)).astype(fdtype)
            arrays[fname] = arr
            origins[fname] = tuple(origin)
        for pname, spec in param_specs.items():
            lo, hi = spec.in_range
            pdtype = np.dtype(spec.dtype or dtype)
            if pdtype.kind in "iu":
                scalars[pname] = pdtype.type(rng.integers(int(lo), int(hi) + 1))
            else:
                scalars[pname] = pdtype.type(lo + (hi - lo) * rng.random())

        expected = {k: v.copy() for k, v in arrays.items()}
        cls.validation(
            **expected, **scalars, domain=domain, origin=origins, externals=externals
        )

        device = config.resolve_device(getattr(cls, "device", None))
        if device.type == "cpu" or backend in ("numpy", "debug"):
            stencil(**arrays, **scalars, origin=origins, domain=domain)
            results = arrays
        else:
            tensors = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
            stencil(**tensors, **scalars, origin=origins, domain=domain)
            results = {k: v.cpu().numpy() for k, v in tensors.items()}

        for fname in field_specs:
            np.testing.assert_allclose(
                results[fname],
                expected[fname],
                rtol=RTOL,
                atol=ATOL,
                err_msg=f"{cls.__name__}: field '{fname}' mismatch "
                f"(backend={backend}, dtype={dtype}, domain={domain})",
            )

    run_one()
