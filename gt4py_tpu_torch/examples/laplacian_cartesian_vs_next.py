"""The 3D Laplacian written in both frontends (the JAX package's
``examples/laplacian_cartesian_vs_next.py``, the reference's flagship
example), on the card.

    python -m gt4py_tpu_torch.examples.laplacian_cartesian_vs_next [--cpu]
"""

from __future__ import annotations

import numpy as np

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config, storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval
from gt4py_tpu_torch.examples import cli, counted
from gt4py_tpu_torch.next import Dimension, FieldOffset, field_operator

# --------------------------- cartesian GTScript --------------------------- #

Field3D = gtscript.Field[np.float64]


def lap_cartesian_defn(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = -4.0 * inp + (
            inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        )


# ----------------------------- next field-view ---------------------------- #

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=I, target=(I,))
Joff = FieldOffset("Joff", source=J, target=(J,))


@field_operator
def lap_next(inp):
    return -4.0 * inp + (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))


def main(device=None, n: int = 128, backend: str = "torch") -> dict:
    """Both Laplacians of the same n^3 draw on ``device``; the cartesian
    one on ``backend``.  Returns the difference and each one's sum."""
    dev = config.resolve_device(device)
    with counted(dev) as count:
        lap_cartesian = gtscript.stencil(backend=backend, name=f"lap_cartesian_{backend}")(
            lap_cartesian_defn)
        rng = np.random.default_rng(0)
        data = rng.random((n, n, n))
        inp = storage.from_array(data, device=dev, aligned_index=(1, 1, 0))
        out = storage.zeros((n, n, n), device=dev, aligned_index=(1, 1, 0))
        lap_cartesian(inp, out)
        cart = out.to_numpy()[1:-1, 1:-1, :]

        f = gtx.as_field((I, J, K), data, device=dev)
        nxt = lap_next(f).asnumpy()
    np.testing.assert_allclose(cart, nxt, rtol=1e-12)
    diff = float(np.abs(cart - nxt).max())
    print(f"cartesian and next agree on the {n}^3 Laplacian (max |diff| = {diff:.2e})")
    return {"device": str(dev), "n": n, "max_abs_diff": diff, "cartesian_sum": float(cart.sum()),
            "next_sum": float(nxt.sum()), **count}


if __name__ == "__main__":
    cli(main)
