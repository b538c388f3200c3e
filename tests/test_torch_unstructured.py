"""The unstructured FVM step on the port, held to the JAX package.

bench.py's ``bench_tpu_unstructured`` step (edge gradient through E2V,
signed divergence through V2E, ``psi + 0.05 * div``) on ``grid_mesh(192)``
(quasi-structured: affine windows) and ``shuffled_mesh(192, 7)``
(irregular: sort-routed gathers, their permutations through
``benes.permute``, the plain butterfly on the CPU), built by
``gt4py_tpu_torch.next.testing.unstructured_fvm_case`` and run embedded on
CPU tensors, against the JAX package's operators on ``jax_jit`` (CPU):
the gathered edge gradient bit for bit, the step at rtol 1e-6 in float32
and 1e-12 in float64 (the two sum the four neighbors in their own
order).  The routed and index paths of the port agree bit for bit.  On
the card the same step launches K9 (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gt4py_tpu.next as jgtx
from gt4py_tpu.next import Dims, Field, FieldOffset, backends, neighbor_sum
from gt4py_tpu.next import testing as jt

from gt4py_tpu_torch import config
from gt4py_tpu_torch.next import affine_remap, benes, sort_route
from gt4py_tpu_torch.next import testing as pt


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


N = 192
RTOL = {np.float32: 1e-6, np.float64: 1e-12}
STEPS = 3


def _jax_case(irregular, dtype):
    """bench.py's operators on the JAX package (``jax_jit``)."""
    mesh = jt.shuffled_mesh(N, seed=7) if irregular else jt.grid_mesh(N)
    E2V = FieldOffset("E2V", source=jt.Vertex, target=(jt.Edge, jt.E2VDim))
    V2E = FieldOffset("V2E", source=jt.Edge, target=(jt.Vertex, jt.V2EDim))
    T = jgtx.float32 if dtype == np.float32 else jgtx.float64

    @jgtx.field_operator
    def gradient(psi: Field[Dims[jt.Vertex], T]) -> Field[Dims[jt.Edge], T]:
        return psi(E2V[1]) - psi(E2V[0])

    @jgtx.field_operator
    def divergence(flux: Field[Dims[jt.Edge], T],
                   sign: Field[Dims[jt.Vertex, jt.V2EDim], T]) -> Field[Dims[jt.Vertex], T]:
        return neighbor_sum(flux(V2E) * sign, axis=jt.V2EDim)

    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    return (mesh, gradient.with_backend(backends.jax_jit),
            divergence.with_backend(backends.jax_jit), provider)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("irregular", [False, True], ids=["grid", "shuffled"])
def test_fvm_step_vs_jax(irregular, dtype):
    case = pt.unstructured_fvm_case(N, irregular, dtype, "cpu")
    mesh, grad, div, provider = _jax_case(irregular, dtype)
    np.testing.assert_array_equal(case["mesh"].e2v.table, np.asarray(mesh.e2v.table))
    sign = jgtx.as_field((jt.Vertex, jt.V2EDim), jnp.asarray(case["sign"].asnumpy()))
    psi_p, psi_j = case["psi0"], jnp.asarray(case["psi0"].numpy())
    assert psi_p.dtype == (torch.float32 if dtype == np.float32 else torch.float64)

    # the gathers: the edge gradient bit for bit
    import gt4py_tpu_torch.next as pgtx

    g_p = case["gradient"](pgtx.as_field((pt.Vertex,), psi_p), offset_provider=case["provider"])
    g_j = grad(jgtx.as_field((jt.Vertex,), psi_j), offset_provider=provider)
    np.testing.assert_array_equal(g_p.asnumpy(), np.asarray(g_j.data))

    for _ in range(STEPS):
        psi_p = case["step"](psi_p)
        d = div(grad(jgtx.as_field((jt.Vertex,), psi_j), offset_provider=provider), sign,
                offset_provider=provider)
        psi_j = psi_j + 0.05 * d.data
    assert bool(torch.isfinite(psi_p).all())
    np.testing.assert_allclose(psi_p.numpy(), np.asarray(psi_j), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("irregular", [False, True], ids=["grid", "shuffled"])
def test_fvm_plans_and_index_path_bitwise(irregular, monkeypatch):
    """The grid mesh's gathers plan as affine windows and run no
    permutation; the shuffled mesh's plan as sort routes whose
    permutations go through ``benes.permute`` (none declines).  Ten steps
    equal ten steps on the index path (``config.AFFINE_GATHER =
    config.SORT_GATHER = False``: one clipped ``index_select`` each) bit
    for bit."""
    calls = []
    real = benes.permute
    monkeypatch.setattr(benes, "permute", lambda v, k: calls.append(v.numel()) or real(v, k))
    case = pt.unstructured_fvm_case(N, irregular, np.float32, "cpu")
    cursor = benes.DECLINES.cursor()
    routed = case["psi0"]
    for _ in range(10):
        routed = case["step"](routed)
    assert not benes.DECLINES.since(cursor)
    cols = case["mesh"].e2v.__dict__["_column_conns"].values()
    plans = [(affine_remap.plan_for(c), sort_route.plan_for(c)) for c in cols] + \
        [(affine_remap.plan_for(case["mesh"].v2e), sort_route.plan_for(case["mesh"].v2e))]
    if irregular:
        assert all(a is None and s is not None for a, s in plans)
        # per step, a seed and one doubling round for each E2V column (a
        # vertex is the first end of up to two edges) and for V2E (an
        # edge has two ends)
        assert len(calls) == 10 * 6
    else:
        assert all(a is not None for a, _ in plans)
        assert not calls
    monkeypatch.setattr(config, "AFFINE_GATHER", False)
    monkeypatch.setattr(config, "SORT_GATHER", False)
    index = case["psi0"]
    for _ in range(10):
        index = case["step"](index)
    assert len(calls) == (10 * 6 if irregular else 0)
    assert torch.equal(routed, index)
