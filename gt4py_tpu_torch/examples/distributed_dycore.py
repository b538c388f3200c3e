"""The distributed mini-dycore on the card (the JAX package's
``examples/distributed_dycore.py``): five timesteps sharded over four
gloo ranks as a 2x2 mesh, each rank a process.  On the card the ranks
share it (their halo strips staged through host memory); with ``--cpu``
they are CPU ranks.  Rank 0 gathers the result.

    python -m gt4py_tpu_torch.examples.distributed_dycore [--cpu]
"""

from __future__ import annotations

import tempfile

import numpy as np

from gt4py_tpu_torch import config
from gt4py_tpu_torch.examples import cli, counted

#: the state's fields with the scales of their draws, in draw order
FIELDS = (("u", 1.0), ("coeff", 0.025), ("wcon", 0.2), ("utens", 0.01), ("utens_stage", 1.0))
#: the mesh, each rank's block (I, J) and the levels
MESH, BLOCK, NK = (2, 2), (32, 32), 16


def state(shape, seed: int = 0):
    """The global (K, I, J) float32 state, drawn as the JAX example draws it."""
    rng = np.random.default_rng(seed)
    return {name: rng.random(shape).astype(np.float32) * s for name, s in FIELDS}


def _rank(cmesh, *, steps: int, backend: str) -> dict:
    """One rank: its blocks of the state, ``steps`` sharded MiniDycore
    steps, and the gathered ``u`` (on rank 0)."""
    from gt4py_tpu_torch.models import MiniDycore
    from gt4py_tpu_torch.parallel import DistributedField, distribute, gather, shard_map_stencil

    px, py = cmesh.shape
    shape = (NK, BLOCK[0] * px, BLOCK[1] * py)
    with counted(cmesh.device) as count:
        model = MiniDycore(*BLOCK, NK, dtype=np.float32, backend=backend, aligned=False,
                           device=cmesh.device)
        h = model.HALO
        lstep = model.step_fn(fill_halos=False)
        step = shard_map_stencil(lambda **kw: lstep(dict(kw)), cmesh, (h, h),
                                 field_names=tuple(n for n, _ in FIELDS), spatial_axes=(1, 2))
        fields = {n: distribute(cmesh, v, spatial_axes=(1, 2)) for n, v in state(shape).items()}
        blocks = {n: f.data for n, f in fields.items()}
        for _ in range(steps):
            blocks = step(**blocks)
        u = gather(DistributedField.from_block(blocks["u"], fields["u"]))
    return {"u": u if cmesh.rank == 0 else None, **count}


def main(device=None, steps: int = 5, backend: str = "torch") -> dict:
    """``steps`` sharded steps on four ranks on ``device`` (the card by
    default) with the stencils on ``backend``; returns the global ``u``
    and its summary."""
    from gt4py_tpu_torch.examples import distributed_dycore as this
    from gt4py_tpu_torch.testing import dist_cases

    dev = config.resolve_device(device)
    ranks = MESH[0] * MESH[1]
    print(f"mesh: {MESH[0]} x {MESH[1]} over {ranks} gloo ranks on {dev.type}")
    with tempfile.TemporaryDirectory(prefix="distributed_dycore_") as work:
        res = dist_cases.launch({"run": dict(case=this._rank, steps=steps, backend=backend)},
                                workdir=work, ranks=ranks, shape=MESH, device=dev.type,
                                strict=True, timeout=600)["run"]
    u = res[0][1]["u"]
    out = {"device": str(dev), "shape": list(u.shape), "u": u, "mean": float(u.mean()),
           "finite": bool(np.isfinite(u).all()),
           "launches": sum(r["launches"] for _, r in res),
           "device_kernels": None if res[0][1]["device_kernels"] is None else
           sum(r["device_kernels"] for _, r in res)}
    assert out["finite"]
    print(f"{steps} steps done; global u: shape={u.shape}, mean={out['mean']:.4f}, "
          f"finite={out['finite']}")
    return out


if __name__ == "__main__":
    cli(main)
