"""The port's differential program fuzzer against the JAX package's.

``gt4py_tpu_torch.testing.program_gen`` draws, for a seed, the program,
domain, arrays and scalars that ``gt4py_tpu.testing.program_gen`` draws
(the same ``pformat_stencil`` text from both generators).  The port's
``"torch"`` executor and its ``"numpy"`` oracle then run it, and both are
held to the JAX package's ``"numpy"`` oracle on the same inputs, at the
JAX fuzzer's tolerances: float64 seeds 0-59 (rtol = atol = 1e-12; the
port's ``"numpy"`` is a copy of the oracle, bit for bit), periodic seeds
0-29 (with the contract that a read halo wider than the periodic domain is
rejected with ``ValueError`` by every backend) and float32 seeds 0-11 in
the models' (K, I, J) ``kij_aligned`` buffers (3e-5 / 3e-6).
"""

import random

import numpy as np
import pytest

from gt4py_tpu.cartesian import analysis as j_analysis
from gt4py_tpu.cartesian.backend import from_name as j_from_name
from gt4py_tpu.cartesian.pretty import pformat_stencil as j_pformat
from gt4py_tpu.testing import program_gen as j_gen

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian.pretty import pformat_stencil
from gt4py_tpu_torch.testing import program_gen


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def jax_program(seed, dtype=np.float64, domain=None):
    """The JAX fuzzer's program for ``seed`` (its non-aligned draws; with a
    ``domain`` given, none is drawn)."""
    rng = random.Random(seed)
    if domain is None:
        domain = (rng.randint(3, 9), rng.randint(3, 9), rng.randint(1, 7))
    return j_gen.ProgramGenerator(rng, dtype=dtype).generate(), domain


def jax_oracle(case, periodic=()):
    """The JAX package's numpy oracle on the case's inputs, or the string
    ``"ValueError"`` when it rejects the call."""
    stencil, domain = jax_program(case.seed, case.dtype,
                                  None if case.drew_domain else case.domain)
    assert domain == case.domain
    arrays = {k: v.astype(case.dtype) for k, v in case.inputs.items()}
    try:
        j_from_name("numpy")(j_analysis.analyze(stencil)).run(
            arrays, case.scalars, domain, {k: case.origin for k in arrays}, periodic=periodic)
    except ValueError:
        return "ValueError"
    return arrays


@pytest.mark.parametrize("seed", range(60))
def test_generators_draw_the_same_program(seed):
    case = program_gen.DifferentialCase(seed)
    assert pformat_stencil(case.stencil) == j_pformat(jax_program(seed)[0])


@pytest.mark.parametrize("seed", range(60))
def test_random_program_parity_f64(seed):
    case = program_gen.run_differential_case(seed, backends=("torch",))
    ref = jax_oracle(case)
    for name in case.names:
        np.testing.assert_array_equal(case.results["numpy"][name], ref[name], err_msg=name)
        np.testing.assert_allclose(case.results["torch"][name], ref[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("seed", range(30))
def test_random_program_periodic_parity(seed):
    periodic = ("I", "J")
    case = program_gen.run_differential_case(seed, backends=("torch",), periodic=periodic)
    ref = jax_oracle(case, periodic)
    if case.rejected:
        assert ref == "ValueError"
        return
    for name in case.names:
        np.testing.assert_array_equal(case.results["numpy"][name], ref[name], err_msg=name)
        np.testing.assert_allclose(case.results["torch"][name], ref[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("seed", range(12))
def test_random_program_f32_kij_aligned(seed):
    case = program_gen.run_differential_case(seed, backends=("torch",), dtype=np.float32,
                                             layout="kij_aligned", rtol=3e-5, atol=3e-6)
    ref = jax_oracle(case)
    for name in case.names:
        np.testing.assert_array_equal(case.results["numpy"][name], ref[name], err_msg=name)
        np.testing.assert_allclose(case.results["torch"][name], ref[name], rtol=3e-5,
                                   atol=3e-6, err_msg=name)


@pytest.mark.parametrize("layout", program_gen.LAYOUTS)
def test_layouts_hold_the_logical_values(layout):
    """Each layout's buffer holds the inputs at their logical (I, J, K)
    places; the (K, I, J) ones are J-contiguous with 16-byte (aligned) or
    odd (tight) row pitches, their padding NaN."""
    import torch

    a = np.random.default_rng(0).random((7, 9, 4))
    t = program_gen._buffer(a, np.float64, layout, "cpu")
    np.testing.assert_array_equal(t.numpy(), a)
    if layout == "ijk":
        assert t.is_contiguous()
        return
    assert t.stride(1) == 1
    pitch = t.stride(0)
    assert pitch % 2 == (1 if layout == "kij_tight" else 0)
    if layout == "kij_aligned":
        assert pitch * 8 % 16 == 0 and t.stride(2) * 8 % 16 == 0
    buf = torch.as_strided(t, (4, 7, pitch), (t.stride(2), pitch, 1))
    assert torch.isnan(buf[:, :, 9:]).all()
