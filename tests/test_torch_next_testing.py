"""The port's case harness (``gt4py_tpu_torch.next.testing``: ``Case``,
``allocate``, ``run``, ``verify``, ``RETURN``, ``UniqueInitializer``,
``ZeroInitializer``) on the CPU, mirroring the JAX package's uses in
``tests/next/test_unstructured.py``: the same operators, allocated from
their parsed parameter types on both harnesses, equal inputs and results
(float64, rtol = atol = 1e-12), on the port's ``"numpy"`` and
``"torch"`` allocators."""

import numpy as np
import pytest
import torch

import gt4py_tpu.next as jnext
import gt4py_tpu_torch.next as pnext
from gt4py_tpu.next import testing as jtesting
from gt4py_tpu_torch import config
from gt4py_tpu_torch.next import testing as ptesting

float64 = np.float64


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def _ops(gtx, t):
    """The test_unstructured operators, built on the DSL package ``gtx``
    with its testing module's mesh dimensions ``t``."""
    Field, Dims = gtx.Field, gtx.type_system.Dims
    Edge, Vertex, V2EDim = t.Edge, t.Vertex, t.V2EDim
    mesh = t.SimpleMesh.make()
    V2E, E2V = mesh.v2e, mesh.e2v

    @gtx.field_operator
    def op(e: Field[Dims[Edge], float64],
           w: Field[Dims[Vertex, V2EDim], float64]) -> Field[Dims[Vertex], float64]:
        return gtx.neighbor_sum(w, axis=V2EDim)

    @gtx.field_operator
    def weighted(e: Field[Dims[Edge], float64],
                 w: Field[Dims[Vertex, V2EDim], float64]) -> Field[Dims[Vertex], float64]:
        return gtx.neighbor_sum(w * e(V2E), axis=V2E)

    @gtx.field_operator
    def endpoint_sum(v: Field[Dims[Vertex], float64]) -> Field[Dims[Edge], float64]:
        return gtx.neighbor_sum(v(E2V), axis=E2V)

    return {"op": op, "weighted": weighted, "endpoint_sum": endpoint_sum}


@pytest.fixture(scope="module")
def ops():
    return {"jax": _ops(jnext, jtesting), "port": _ops(pnext, ptesting)}


@pytest.mark.parametrize("allocator", ["numpy", "torch"])
def test_allocate_from_param_types(ops, allocator):
    """``allocate`` derives each argument's dims, shape and dtype from the
    operator's parameter types, ``RETURN`` its result's; the shared
    ``UniqueInitializer`` gives the JAX harness's values, all distinct."""
    case, mesh = ptesting.simple_mesh_case(allocator=allocator)
    jcase, _ = jtesting.simple_mesh_case()
    got = {n: ptesting.allocate(case, ops["port"]["op"], n) for n in ("e", "w")}
    ref = {n: jtesting.allocate(jcase, ops["jax"]["op"], n) for n in ("e", "w")}
    out = ptesting.allocate(case, ops["port"]["op"], ptesting.RETURN)
    assert got["e"].dims == (ptesting.Edge,) and got["e"].shape == (mesh.n_edges,)
    assert got["w"].dims == (ptesting.Vertex, ptesting.V2EDim)
    assert got["w"].shape == (mesh.n_vertices, mesh.v2e.max_neighbors)
    assert out.shape == (mesh.n_vertices,) and not out.asnumpy().any()
    assert isinstance(got["e"].data, np.ndarray if allocator == "numpy" else torch.Tensor)
    for n in got:
        np.testing.assert_array_equal(got[n].asnumpy(), ref[n].asnumpy())
    vals = np.concatenate([got["e"].asnumpy().ravel(), got["w"].asnumpy().ravel()])
    assert len(np.unique(vals)) == len(vals)


@pytest.mark.parametrize("allocator", ["numpy", "torch"])
def test_sparse_weighted_neighbor_sum_with_skips(ops, allocator):
    """A sparse weight field times the remapped edge values, skipped slots
    contributing nothing: ``verify`` against the loop reference, and the
    result equal to the JAX harness's run of the same operator."""
    case, mesh = ptesting.simple_mesh_case(allocator=allocator)
    jcase, _ = jtesting.simple_mesh_case()
    e = ptesting.allocate(case, ops["port"]["weighted"], "e",
                          strategy=ptesting.UniqueInitializer(1))
    w = ptesting.allocate(case, ops["port"]["weighted"], "w",
                          strategy=ptesting.UniqueInitializer(100))
    ev, wv = e.asnumpy(), w.asnumpy()
    expect = np.zeros(mesh.n_vertices)
    for v in range(mesh.n_vertices):
        for s, nb in enumerate(mesh.v2e.table[v]):
            if nb != mesh.v2e.skip_value:
                expect[v] += wv[v, s] * ev[nb]
    got = ptesting.verify(case, ops["port"]["weighted"], e, w, ref=expect)
    je = jtesting.allocate(jcase, ops["jax"]["weighted"], "e",
                           strategy=jtesting.UniqueInitializer(1))
    jw = jtesting.allocate(jcase, ops["jax"]["weighted"], "w",
                           strategy=jtesting.UniqueInitializer(100))
    ref = jtesting.run(jcase, ops["jax"]["weighted"], je, jw)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("allocator", ["numpy", "torch"])
def test_remap_of_sparse_vertex_field(ops, allocator):
    """The e2v remap reduced per edge: ``verify`` against numpy, with a
    tensor reference too, and the JAX harness's result."""
    case, mesh = ptesting.simple_mesh_case(allocator=allocator)
    jcase, _ = jtesting.simple_mesh_case()
    v = ptesting.allocate(case, ops["port"]["endpoint_sum"], "v",
                          strategy=ptesting.UniqueInitializer(1))
    expect = v.asnumpy()[mesh.e2v.table].sum(axis=1)
    got = ptesting.verify(case, ops["port"]["endpoint_sum"], v, ref=expect)
    ptesting.verify(case, ops["port"]["endpoint_sum"], v, ref=torch.from_numpy(expect))
    jv = jtesting.allocate(jcase, ops["jax"]["endpoint_sum"], "v",
                           strategy=jtesting.UniqueInitializer(1))
    ref = jtesting.run(jcase, ops["jax"]["endpoint_sum"], jv)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-12, atol=1e-12)


def test_verify_fails_and_refusals():
    """``verify`` raises where the result differs beyond the tolerance;
    ``allocate`` refuses a scalar parameter, an unknown name and an
    unknown allocator; ``ZeroInitializer`` fills zeros."""
    case, _ = ptesting.simple_mesh_case(allocator="torch")
    op = _ops(pnext, ptesting)["endpoint_sum"]
    v = ptesting.allocate(case, op, "v")
    with pytest.raises(AssertionError):
        ptesting.verify(case, op, v, ref=np.zeros(case.size(ptesting.Edge)))
    with pytest.raises(KeyError):
        ptesting.allocate(case, op, "nope")
    with pytest.raises(ValueError, match="allocator"):
        ptesting.Case(default_sizes={}, allocator="jax")
    z = ptesting.allocate(case, op, "v", strategy=ptesting.ZeroInitializer())
    assert not z.asnumpy().any()
