"""The distributed field-view DSL on the card (the JAX package's
``examples/distributed_next.py``): a next Field sharded over four gloo
ranks as a 2x2 mesh, each rank a process, a Laplacian into a column scan
on the sharded fields (each rank exchanges the halo the operator reads),
and the result gathered on rank 0 and held to the numpy oracle.

    python -m gt4py_tpu_torch.examples.distributed_next [--cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch.examples import cli, counted
from gt4py_tpu_torch.next import Dims, Field

I = gtx.Dimension("I")
J = gtx.Dimension("J")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
#: the mesh, each rank's block (I, J) and the levels
MESH, BLOCK, NK = (2, 2), (16, 16), 8


@gtx.field_operator
def laplacian(f: Field[Dims[I, J, K], gtx.float32]) -> Field[Dims[I, J, K], gtx.float32]:
    return f(Ioff[1]) + f(Ioff[-1]) + f(Joff[1]) + f(Joff[-1]) - 4.0 * f


@gtx.scan_operator(axis=K, forward=True, init=np.float32(0.0))
def column_integral(carry: gtx.float32, x: gtx.float32) -> gtx.float32:
    return carry + x


def data(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _rank(cmesh) -> dict:
    """One rank: its block of the field, the operators on it, and the
    gathered result (on rank 0)."""
    from gt4py_tpu_torch.next import distributed as nxd

    px, py = cmesh.shape
    with counted(cmesh.device) as count:
        f = gtx.as_field((I, J, K), data((BLOCK[0] * px, BLOCK[1] * py, NK)),
                         device=cmesh.device)
        # I over mesh axis x, J over y; K stays on each rank (the scan
        # needs the whole column)
        fd = nxd.distribute(f, cmesh, {I: "x", J: "y"})
        placement = nxd.sharding_of(fd)
        out = column_integral(laplacian(fd))
        got = nxd.gather(out)
    return {"out": got.asnumpy() if cmesh.rank == 0 else None,
            "ranges": [(r.start, r.stop) for r in got.domain.ranges],
            "dim_map": {d.value: ax for d, ax in placement.dim_map.items()}, **count}


def main(device=None) -> dict:
    """The sharded operators on four ranks on ``device`` (the card by
    default); returns the gathered result and its difference from the
    numpy oracle."""
    from gt4py_tpu_torch.examples import distributed_next as this
    from gt4py_tpu_torch.testing import dist_cases

    dev = config.resolve_device(device)
    ranks = MESH[0] * MESH[1]
    print(f"mesh: {MESH[0]}x{MESH[1]} over {ranks} gloo ranks on {dev.type}")
    with tempfile.TemporaryDirectory(prefix="distributed_next_") as work:
        res = dist_cases.launch({"run": dict(case=this._rank)}, workdir=work, ranks=ranks,
                                shape=MESH, device=dev.type, strict=True, timeout=600)["run"]
    r0 = res[0][1]
    got = r0["out"]
    print("input sharding:", r0["dim_map"], "; output shape:", got.shape)
    f = data((BLOCK[0] * MESH[0], BLOCK[1] * MESH[1], NK))
    ref = np.cumsum(laplacian(gtx.as_field((I, J, K), f, allocator="numpy")).asnumpy(),
                    axis=2, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)
    print("matches the numpy oracle -- OK")
    return {"device": str(dev), "shape": list(got.shape), "out": got,
            "ranges": r0["ranges"], "max_abs_err": float(np.abs(got - ref).max()),
            "launches": sum(r["launches"] for _, r in res),
            "device_kernels": None if r0["device_kernels"] is None else
            sum(r["device_kernels"] for _, r in res)}


if __name__ == "__main__":
    cli(main)
