"""Finite-volume operators on an unstructured mesh on the card (the JAX
package's ``examples/unstructured_fvm.py``): gradient and divergence
through call-time offset providers, and a two-hop chain folded into one
gather.

The mesh is a 3x3 quad patch exposed as vertex/edge connectivity tables
(``gt4py_tpu_torch.next.testing.SimpleMesh``); boundary vertices have
fewer than 4 incident edges (skip values), which the reductions mask.

    python -m gt4py_tpu_torch.examples.unstructured_fvm [--cpu]
"""

from __future__ import annotations

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch.examples import cli, counted
from gt4py_tpu_torch.next import Dims, Field, FieldOffset, neighbor_sum
from gt4py_tpu_torch.next.testing import E2VDim, Edge, SimpleMesh, V2EDim, Vertex

# named offsets: the field carries ``source``, the result ``target``; the
# neighbour tables arrive per call through ``offset_provider``
E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
f64 = gtx.float64


@gtx.field_operator
def gradient(psi: Field[Dims[Vertex], f64]) -> Field[Dims[Edge], f64]:
    """Per-edge difference of the endpoint values: E2V[k] selects the k-th
    endpoint through the call-time provider table."""
    return psi(E2V[1]) - psi(E2V[0])


@gtx.field_operator
def divergence(flux: Field[Dims[Edge], f64],
               sign: Field[Dims[Vertex, V2EDim], f64]) -> Field[Dims[Vertex], f64]:
    """Signed sum of incident edge fluxes; skipped neighbour slots of
    boundary vertices contribute nothing."""
    return neighbor_sum(flux(V2E) * sign, axis=V2EDim)


@gtx.field_operator
def second_ring(v: Field[Dims[Vertex], f64]) -> Field[Dims[Vertex], f64]:
    return v(E2V[0], V2E[1])


def main(device=None) -> dict:
    """The gradient, divergence and two-hop chain on ``device``; returns
    their values."""
    dev = config.resolve_device(device)
    mesh = SimpleMesh.make()
    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    with counted(dev) as count:
        # psi = x + 2y on the 3x3 vertex grid
        xv, yv = np.meshgrid(np.arange(3.0), np.arange(3.0), indexing="xy")
        psi_np = (xv + 2 * yv).ravel()
        psi = gtx.as_field((Vertex,), psi_np, device=dev)
        grad = gradient(psi, offset_provider=provider)
        expected_grad = psi_np[mesh.e2v.table[:, 1]] - psi_np[mesh.e2v.table[:, 0]]
        np.testing.assert_allclose(grad.asnumpy(), expected_grad)
        print("edge gradient :", grad.asnumpy())

        # outward sign of each incident edge per vertex: +1 where the
        # vertex is the edge's first endpoint, -1 where second, 0 at skips
        t = mesh.v2e.table
        first = mesh.e2v.table[np.clip(t, 0, mesh.n_edges - 1), 0]
        sign_np = np.where(t == -1, 0.0, np.where(first == np.arange(9)[:, None], 1.0, -1.0))
        sign = gtx.as_field((Vertex, V2EDim), sign_np, device=dev)
        div = divergence(grad, sign, offset_provider=provider)
        mask = t != -1
        fluxes = expected_grad[np.clip(t, 0, mesh.n_edges - 1)]
        expected_div = np.where(mask, fluxes * sign_np, 0.0).sum(axis=1)
        np.testing.assert_allclose(div.asnumpy(), expected_div)
        print("vertex divergence:", div.asnumpy())
        # over a closed stencil the divergences telescope: every interior
        # edge appears once with each sign
        assert abs(div.asnumpy().sum()) < 1e-12
        print("OK: gradient/divergence verified (skip values masked, "
              "sum(div) telescopes to 0)")

        # a two-hop chain (vertex -> edge -> vertex) folds into ONE gather
        ring = second_ring(psi, offset_provider=provider)
        vv = psi.asnumpy()
        exp_ring = vv[mesh.e2v.table[:, 0]][np.clip(mesh.v2e.table[:, 1], 0, None)]
        np.testing.assert_allclose(ring.asnumpy(), exp_ring, rtol=1e-15)
        print("OK: two-hop chain == composed gather (bitwise)")
    return {"device": str(dev), "gradient": grad.asnumpy().tolist(),
            "divergence": div.asnumpy().tolist(), "second_ring": ring.asnumpy().tolist(),
            **count}


if __name__ == "__main__":
    cli(main)
