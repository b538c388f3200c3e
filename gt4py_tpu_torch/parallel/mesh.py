"""The rank mesh for 2D horizontal domain decomposition.

Counterpart of ``gt4py_tpu.parallel.mesh``.  The JAX package maps a mesh
of local devices in one process; here each rank is a process of a
``torch.distributed`` job (how PyTorch runs SPMD), and the mesh lays the
job's ranks out x-major: ``rank = x * py + y``, "x" along I and "y"
along J.

The wire is explicit.  NCCL carries device tensors where each rank has a
card of its own; gloo runs where the caller asks for it and always on the
CPU.  More ranks than cards without ``backend="gloo"`` raises: NCCL
refuses two ranks on one card (``Duplicate GPU detected``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gt4py_tpu_torch import config


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square factorization of n (px * py = n, px <= py)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else the card
    ``LOCAL_RANK % device_count`` (an explicit ``cuda:<n>`` is kept)."""
    dev = config.resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, backend: Optional[str], ranks_here: int) -> str:
    """The wire of a mesh on ``device`` with ``ranks_here`` ranks on this
    host (see the module docstring)."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL carries CUDA tensors only: a mesh on the CPU runs gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if ranks_here > cards:
        raise ValueError(
            f"{ranks_here} ranks on this host share {cards} card(s): NCCL refuses two ranks "
            "on one card (Duplicate GPU detected); pass backend='gloo' (strips staged "
            "through host memory)")
    return "nccl"


class CartesianMesh:
    """The ranks of the default process group as a (px, py) mesh, "x" along
    I and "y" along J.  Without an initialized process group it is the
    single-rank mesh (1, 1) of this process.  ``device``: this rank's
    device (``rank_device``); ``backend``: the wire (``choose_backend``).
    Exchanges run on a process group of that backend over all ranks."""

    AXES = ("x", "y")

    def __init__(self, shape: Optional[Tuple[int, int]] = None, *, device=None,
                 backend: Optional[str] = None):
        self.device = rank_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        #: the mesh spans the process group (False: this process alone)
        self.distributed = dist.is_initialized()
        if self.distributed:
            n, self.rank = dist.get_world_size(), dist.get_rank()
        else:
            n, self.rank = 1, 0
        px, py = _factor2(n) if shape is None else (int(shape[0]), int(shape[1]))
        if px * py != n:
            raise ValueError(f"a {px}x{py} mesh needs {px * py} ranks, the job has {n}")
        self.shape = (px, py)
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        self.backend = choose_backend(self.device, backend, ranks_here)
        self.group = None
        if dist.is_initialized() and dist.get_backend() != self.backend:
            self.group = dist.new_group(backend=self.backend)

    @property
    def px(self) -> int:
        return self.shape[0]

    @property
    def py(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.px * self.py

    @classmethod
    def single(cls, device=None) -> "CartesianMesh":
        """The (1, 1) mesh of this process alone, also inside a job: its
        exchanges fill every halo locally."""
        out = cls.__new__(cls)
        out.device = rank_device(device)
        out.distributed, out.rank, out.shape = False, 0, (1, 1)
        out.backend, out.group = "gloo" if out.device.type == "cpu" else "local", None
        return out

    def axis_size(self, axis: str) -> int:
        return self.shape[self.AXES.index(axis)]

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(x, y) of ``rank`` (default: this rank)."""
        rank = self.rank if rank is None else rank
        return rank // self.py, rank % self.py

    def rank_of(self, x: int, y: int) -> int:
        return x * self.py + y

    def neighbours(self, axis: str, periodic: bool = True) -> Tuple[Optional[int], Optional[int]]:
        """(lower, upper) neighbour ranks of this rank along ``axis``; None
        past an open edge."""
        a = self.AXES.index(axis)
        n = self.shape[a]
        pos = list(self.coords())
        out = []
        for step in (-1, 1):
            p = pos[a] + step
            if not 0 <= p < n:
                if not periodic:
                    out.append(None)
                    continue
                p %= n
            q = list(pos)
            q[a] = p
            out.append(self.rank_of(*q))
        return out[0], out[1]

    def __repr__(self):
        return (f"CartesianMesh({self.px}x{self.py}, rank {self.rank}, device {self.device}, "
                f"backend {self.backend})")

    @classmethod
    def initialize_multihost(cls, **kwargs) -> "CartesianMesh":
        """Initialize the default process group from the standard
        environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
        ``WORLD_SIZE``), then build the mesh over its ranks.  With none of
        them set this is a no-op (the single-rank mesh); with them set a
        failure raises."""
        initialize_multihost(kwargs.get("backend"), kwargs.get("device"))
        return cls(**kwargs)


_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize_multihost(backend: Optional[str] = None, device=None) -> bool:
    """``dist.init_process_group`` from the environment (``env://``); True
    when this call initialized it.  A no-op without the environment or
    when a group exists already."""
    if dist.is_initialized() or not any(os.environ.get(v) for v in _ENV):
        return False
    dev = config.resolve_device(device)
    dist.init_process_group(backend=backend or ("gloo" if dev.type == "cpu" else "nccl"),
                            init_method="env://")
    return True
