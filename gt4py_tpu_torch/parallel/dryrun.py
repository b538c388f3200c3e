"""The multi-rank dry run: the distributed steps on a job of gloo ranks.

Counterpart of the JAX package's ``dryrun_multichip`` (its multi-device entry
point), which shards the full timestep over a virtual mesh of CPU devices.
Here ``dryrun_multirank(n)`` starts ``n`` ranks (``torch.multiprocessing``,
start method ``spawn``, a file store in a temporary directory) on
``device``: on the card all ranks share it through gloo with their strips
staged through host memory; on the CPU they are gloo ranks over CPU
tensors.  It runs the sharded MiniDycore step at tiny blocks, the
overlapped step and the FvAdvection step at ``size``, and a field-view
operator on sharded fields, and raises where a result is not finite or
the tracer mass moves.

    python -c "from gt4py_tpu_torch.parallel.dryrun import dryrun_multirank; \\
               dryrun_multirank(4)"
"""

from __future__ import annotations

import tempfile
from typing import Tuple

import numpy as np

from gt4py_tpu_torch.parallel.mesh import _factor2


def dryrun_multirank(n_ranks: int, *, device: str = "cuda",
                     size: Tuple[int, int, int] = (80, 512, 512)) -> dict:
    """Run the dry run on ``n_ranks`` ranks; ``size`` is the global (K, I, J)
    of the bench-scale legs.  Returns rank 0's results."""
    from gt4py_tpu_torch.testing import dist_cases

    px, py = _factor2(n_ranks)
    nk, ni, nj = size
    cases = {
        "tiny": dict(case="dycore", shape=(6, 8 * px, 8 * py), dtype="float32"),
        "overlap": dict(case="dycore", shape=size, dtype="float32", mode="overlap"),
        "fv": dict(case="fv", shape=size, dtype="float32"),
        "next_lap": dict(case="next_lap"),
    }
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        res = dist_cases.launch(cases, workdir=work, ranks=n_ranks, shape=(px, py),
                                device=device, strict=True, timeout=600)
    out = {k: v[0][1] for k, v in res.items()}
    for key in ("tiny", "overlap"):
        u = out[key]["u"]
        if not np.isfinite(u).all():
            raise RuntimeError(f"dryrun_multirank: the {key} step is not finite")
    q0 = dist_cases.fv_state(size, 7, np.float32)["q"].sum(dtype=np.float64)
    q = out["fv"]["q"]
    if not np.isfinite(q).all() or abs(q.sum(dtype=np.float64) - q0) >= 1e-4 * abs(q0):
        raise RuntimeError("dryrun_multirank: the FV step is not finite or moved tracer mass")
    print(f"dryrun_multirank OK: {px}x{py} mesh of {n_ranks} gloo ranks on {device}: "
          f"MiniDycore at {8 * px}x{8 * py}x6, overlapped MiniDycore and FvAdvection at "
          f"{ni}x{nj}x{nk} float32, a field operator on sharded fields")
    return out
