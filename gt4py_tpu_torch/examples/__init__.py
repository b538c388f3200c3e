"""The JAX package's examples (``examples/*.py``), ported to the card.

One module for each script, with the same name, sizes and seeds; the
port's ``"numpy"``, ``"torch"`` and ``"cuda"`` backends stand where the
JAX ones use ``"numpy"``, ``"jax"`` and ``"pallas"``.  Each runs as

    python -m gt4py_tpu_torch.examples.<name>          # on the card
    python -m gt4py_tpu_torch.examples.<name> --cpu    # on the CPU

and has ``main(device=None, ...)`` (``device="cpu"`` for the CPU; no
example falls back to it) that returns the numbers it prints.  The last
line a run prints is one JSON object of them, with ``launches``: the
kernel launches that the stencil libraries and K9 counted during the run
(the ranks' summed in the distributed examples), and ``device_kernels``:
the CUDA kernels ``torch.profiler`` saw, counted where the environment
sets ``GT4PY_TPU_TORCH_EXAMPLE_KERNELS=1`` on the card (None elsewhere).
The arrays among the numbers are left out of that line; where the
environment names a file in ``GT4PY_TPU_TORCH_EXAMPLE_ARRAYS``, they are
saved there (``numpy.savez``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Callable, Dict

EXAMPLES = ("cartesian_tutorial", "laplacian_cartesian_vs_next", "next_quickstart",
            "unstructured_fvm", "distributed_dycore", "distributed_next")


def launches() -> int:
    """The kernel launches this process's stencil libraries and K9 have
    made so far."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import library_launches
    from gt4py_tpu_torch.next import benes

    return library_launches() + benes.KERNEL.launches


@contextlib.contextmanager
def counted(device):
    """Counts the kernels run inside the block into the yielded dict:
    ``launches`` (``launches()``) and ``device_kernels`` (see the module
    docstring)."""
    import torch

    out: Dict[str, object] = {"device_kernels": None}
    profile = torch.device(device).type == "cuda" and \
        os.environ.get("GT4PY_TPU_TORCH_EXAMPLE_KERNELS") == "1"
    before = launches()
    if not profile:
        yield out
        out["launches"] = launches() - before
        return
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out["launches"] = launches() - before
    out["device_kernels"] = sum(e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA)


def cli(main: Callable[..., dict]) -> None:
    """Run ``main`` on the card, or on the CPU with ``--cpu``, and print
    its numbers as the last line (one JSON object)."""
    args = sys.argv[1:]
    if args not in ([], ["--cpu"]):
        sys.exit(f"usage: python -m {main.__module__} [--cpu]")
    import numpy as np

    result = main(device="cpu" if args else None)
    arrays = {k: v for k, v in result.items() if isinstance(v, np.ndarray)}
    if os.environ.get("GT4PY_TPU_TORCH_EXAMPLE_ARRAYS"):
        np.savez(os.environ["GT4PY_TPU_TORCH_EXAMPLE_ARRAYS"], **arrays)
    print(json.dumps({k: v for k, v in result.items() if k not in arrays}, default=float))
