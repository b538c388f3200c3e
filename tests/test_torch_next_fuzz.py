"""The port's next-DSL fuzzers against the JAX package's.

``gt4py_tpu_torch.testing.next_fuzz`` draws, for a seed, the source text
``gt4py_tpu.testing.next_fuzz`` draws (its generators are copies), and its
case builders take the package that defines the DSL: each case is built a
second time on ``gt4py_tpu.next`` and run on that package's numpy oracle.
The port's numpy oracle, its embedded torch run and its ``"cuda"`` run (on
the CPU: the plain executor of each lowered kernel; operators the bridge
declines run embedded and are counted) must all match it -- dims, domains
and values at rtol = atol = 1e-12 -- for operators 0-19, programs 0-9 and
bridge cases 0-19.
"""

import random
import warnings

import numpy as np
import pytest

import gt4py_tpu.next as jgtx
from gt4py_tpu.testing import next_fuzz as j_nf

from gt4py_tpu_torch import config
from gt4py_tpu_torch.testing import next_fuzz

NUMPY = {"allocator": "numpy"}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU (and the bridge's fallback warnings stay quiet)."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", config.PerformanceFallbackWarning)
        yield


def _jax_operator_source(seed):
    """The JAX fuzzer's operator source for ``seed`` (its draw order)."""
    rng = random.Random(seed)
    unstructured = rng.random() < 0.3
    provider = unstructured and rng.random() < 0.5
    collection = not unstructured and rng.random() < 0.35
    return j_nf.OperatorGenerator(rng, with_unstructured=unstructured,
                                  with_collection=collection,
                                  with_provider=provider).generate()


def _values(result):
    return result if isinstance(result, str) else tuple(
        (np.asarray(v, dtype=np.float64), d, dom) if isinstance(d, tuple) else v
        for v, d, dom in result)


def _same(ref, got, what):
    """``got`` (the port's) equals the JAX oracle's ``ref``: values at
    1e-12, dims and domain ranges by their names and bounds."""
    if isinstance(ref, str) or isinstance(got, str):
        assert ref == got, what
        return
    assert len(ref) == len(got), what
    for (rv, rd, rdom), (gv, gd, gdom) in zip(ref, got):
        assert [d.value for d in rd] == [d.value for d in gd], what
        assert [(r.start, r.stop) for r in rdom] == [(r.start, r.stop) for r in gdom], what
        np.testing.assert_allclose(gv, rv, rtol=1e-12, atol=1e-12, err_msg=what)


@pytest.mark.parametrize("seed", range(20))
def test_random_field_operator_parity(seed):
    case = next_fuzz.run_differential_case(seed)
    assert case.src == _jax_operator_source(seed)
    jc = next_fuzz.operator_case(seed, jgtx, conn_kw=NUMPY)
    assert jc.src == case.src
    a = jgtx.as_field(jc.dims, jc.a.copy(), allocator="numpy")
    b = jgtx.as_field(jc.dims, jc.b.copy(), allocator="numpy")
    try:
        ref = next_fuzz._result(jc.call(jc.op, a, b, jc.s))
    except ValueError as e:
        ref = type(e).__name__
    for label in ("numpy_oracle", "torch", "cuda"):
        _same(ref, case.results[label], f"seed {seed} {label}\n{case.src}")


@pytest.mark.parametrize("seed", range(10))
def test_random_program_parity(seed):
    case = next_fuzz.run_program_case(seed)
    jc = next_fuzz.program_case(seed, jgtx, NUMPY)
    assert jc.src == case.src
    ref = jc.run(jgtx.backends.numpy_oracle, NUMPY)[0]
    for label in ("numpy_oracle", "embedded", "torch", "cuda"):
        got = case.results[label]
        if isinstance(ref, str) or isinstance(got, str):
            assert ref == got, f"seed {seed} {label}"
            continue
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12,
                                       err_msg=f"seed {seed} {label}\n{case.src}")


@pytest.mark.parametrize("seed", range(20))
def test_random_bridge_parity(seed):
    case = next_fuzz.run_bridge_case(seed)
    jc = next_fuzz.bridge_case(seed, jgtx)
    assert jc.src == case.src
    ref = jc.run(jgtx.backends.numpy_oracle, NUMPY)[0]
    for label in ("numpy_oracle", "torch", "cuda"):
        _same(ref, case.results[label], f"seed {seed} {label}\n{case.src}")


def test_bridge_fuzz_lowers():
    """A share of the bridge cases lowers to kernel plans (a leg that only
    ever ran embedded would hold nothing of the kernels); the JAX package's
    corpus test asks 16 of 40."""
    lowered = sum(next_fuzz.run_bridge_case(s).lowered for s in range(20))
    assert lowered >= 8, lowered


@pytest.mark.parametrize("seed", [12, 13, 16])
def test_fuzz_regression_scalar_operand_of_maximum(seed):
    """Fuzz-found (operator seeds 12, 13, 14, 16, 19): ``maximum`` and
    ``minimum`` of a field expression and a Python scalar raised
    ``TypeError`` on torch (``torch.maximum`` takes tensors only); the
    scalar now joins as a 0-d tensor of the operation's dtype."""
    case = next_fuzz.run_differential_case(seed)
    assert not isinstance(case.results["torch"], str)
