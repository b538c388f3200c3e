"""Beneš-network static permutations: the host router and the K9 kernel.

The counterpart of ``gt4py_tpu.next.benes``.  A static permutation
``y[i] = x[perm[i]]`` on n = 2^k elements factors into 2k-1 butterfly
exchange stages (distances n/2, ..., 2, 1, 2, ..., n/2; pairs (i, i^d)
swap or pass).  Routing the control bits is a 2-colouring done once per
permutation on the host (``csrc/benes_router.cpp``, built with g++ into
``config.BUILD_DIR`` at first use); applying them is pure data movement:

- on CUDA tensors, the K9 kernel (``csrc/benes.cu``, built with nvcc at
  first use): one pass over blocks of ``2**_BLOCK_LOG2`` words in shared
  memory for every stage with distance below the block, and one global
  pass per outer stage (the JAX package runs those as XLA selects);
- on CPU tensors, the plain version: the same stages as ``torch.where``
  over pairs (``simulate`` on tensors), from the same packed bits.

Eligibility is the JAX package's: a 1-D float32, int32 or uint32 tensor
whose padded size is at most ``2**_MAX_LOG2``.  An ineligible call
declines (returns None; the caller takes the index path) and records its
reason in ``DECLINES``.  Once eligible, a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.core.events import EventLog

#: log2 of the inner block, in 32-bit words.  2^13 words are 32 KB of
#: shared memory, under the 48 KB a CTA gets without opting in: at the
#: FVM's 2^19-2^20 element permutations that is 64-128 CTAs, about one per
#: SM of the H100's 132, and each further doubling of the block (fewer
#: outer stages, two fewer global passes) would halve the CTAs in flight.
_BLOCK_LOG2 = 13
#: largest supported padded size (the JAX package's limit)
_MAX_LOG2 = 24

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

#: declined calls, each ``(reason, detail)``; reasons: ``"ndim"``,
#: ``"dtype"``, ``"size"``
DECLINES = EventLog()

_ELIGIBLE = (torch.float32, torch.int32, torch.uint32)


class BuildError(RuntimeError):
    pass


# --------------------------------------------------------------------------- #
# host router
# --------------------------------------------------------------------------- #

_router = None


def _load_router():
    """Build (once per source, into ``config.BUILD_DIR``) and load the C++
    router.  A failed build raises ``BuildError``."""
    global _router
    if _router is not None:
        return _router
    src = os.path.join(_CSRC, "benes_router.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(config.BUILD_DIR, "host")
    so = os.path.join(out_dir, f"libbenes_router_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"g++ failed for benes_router.cpp:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.route_benes.restype = ctypes.c_int
    lib.route_benes.argtypes = [
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    _router = lib
    return lib


def route(perm: np.ndarray) -> np.ndarray:
    """Control bits for ``y[i] = x[perm[i]]``: uint8 (2k-1, n), n a power
    of two, each pair's bit on both of its members."""
    lib = _load_router()
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = perm.size
    k = int(n).bit_length() - 1
    if (1 << k) != n or k < 1:
        raise ValueError(f"benes.route needs a power-of-two size, got {n}")
    ctrl = np.empty((2 * k - 1) * n, dtype=np.uint8)
    rc = lib.route_benes(np.int32(k), perm, ctrl)
    if rc != 0:
        raise RuntimeError(f"benes_router failed (code {rc})")
    return ctrl.reshape(2 * k - 1, n)


def stage_distances(k: int) -> list:
    """Exchange distance per stage: n/2, ..., 2, 1, 2, ..., n/2."""
    down = [1 << (k - 1 - l) for l in range(k)]
    return down + down[-2::-1]


def simulate(x: np.ndarray, ctrl: np.ndarray) -> np.ndarray:
    """Apply the staged network in numpy (reference executor, tests)."""
    n = x.shape[0]
    k = int(n).bit_length() - 1
    y = x.copy()
    idx = np.arange(n)
    for s, d in enumerate(stage_distances(k)):
        y = np.where(ctrl[s].astype(bool), y[idx ^ d], y)
    return y


# --------------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------------- #


def pack_pair_bits(ctrl: np.ndarray) -> np.ndarray:
    """(2k-1, n) router bits -> (2k-1, words) uint32 bit-planes, one bit per
    pair: pair q of the stage at distance d (lower member i, bit log2(d) of
    i clear, pairs numbered in increasing i) is bit q % 32 of word q // 32.
    ``words = max(1, n // 64)``."""
    n_stages, n = ctrl.shape
    k = int(n).bit_length() - 1
    words = max(1, n // 64)
    out = np.zeros((n_stages, words * 4), dtype=np.uint8)
    for s, d in enumerate(stage_distances(k)):
        lower = ctrl[s].reshape(n // (2 * d), 2, d)[:, 0, :].reshape(-1)
        packed = np.packbits(lower.astype(np.uint8), bitorder="little")
        out[s, : packed.size] = packed
    return out.view("<u4").astype(np.uint32)


class Plan:
    """A routed permutation: ``dest[j] = src[sigma(j)]`` for j < P on the
    padded size n2 = 2^k (identity on the tail), with its packed bits; the
    device copy of the bits is made at the first launch on each device."""

    def __init__(self, P: int, k: int, bits: np.ndarray):
        self.P = P
        self.k = k
        self.n2 = 1 << k
        self.b = min(_BLOCK_LOG2, k)
        self.bits = bits
        self._device_bits = {}

    def device_bits(self, device) -> torch.Tensor:
        t = self._device_bits.get(device)
        if t is None:
            t = torch.from_numpy(self.bits.view(np.int32)).to(device)
            self._device_bits[device] = t
        return t


_plan_cache: dict = {}
_PLAN_CACHE_MAX = 256


def _plan(keys_np: np.ndarray) -> Optional[Plan]:
    """Plan for the permutation encoded by sort keys (``dest[j] =
    src[sigma(j)]`` with ``keys = sigma^-1``); None when the padded size
    exceeds ``2**_MAX_LOG2``.  Cached on the keys' identity plus a strided
    content sample (``id()`` alone is unsafe across allocator reuse);
    the cache holds at most ``_PLAN_CACHE_MAX`` plans."""
    step = max(1, keys_np.shape[0] // 64)
    token = (id(keys_np), keys_np.shape[0],
             hash(np.ascontiguousarray(keys_np[::step][:64]).tobytes()))
    plan = _plan_cache.get(token)
    if plan is not None:
        return plan
    P = keys_np.shape[0]
    k = max(1, int(P - 1).bit_length())
    if k > _MAX_LOG2:
        return None
    n2 = 1 << k
    sigma = np.empty(n2, dtype=np.int64)
    inv = np.empty(P, dtype=np.int64)
    inv[keys_np] = np.arange(P, dtype=np.int64)
    sigma[:P] = inv
    sigma[P:] = np.arange(P, n2, dtype=np.int64)  # identity tail
    plan = Plan(P, k, pack_pair_bits(route(sigma)))
    if len(_plan_cache) >= _PLAN_CACHE_MAX:
        _plan_cache.clear()
    _plan_cache[token] = plan
    return plan


# --------------------------------------------------------------------------- #
# the kernel and its plain version
# --------------------------------------------------------------------------- #


def plain_inplace(x: torch.Tensor, plan: Plan) -> None:
    """The plain butterfly on ``x`` (n2 int32 words), in place: every stage
    as one ``torch.where`` over the pairs, from the plan's packed bits."""
    n2 = plan.n2
    bits = torch.from_numpy(plan.bits.view(np.int32)).to(x.device)
    q = torch.arange(n2 // 2, device=x.device)
    for s, d in enumerate(stage_distances(plan.k)):
        words = bits[s][q >> 5]
        swap = ((words >> (q & 31).to(torch.int32)) & 1).bool().reshape(n2 // (2 * d), d)
        pairs = x.view(n2 // (2 * d), 2, d)
        lo, hi = pairs[:, 0, :], pairs[:, 1, :]
        pairs.copy_(torch.stack((torch.where(swap, hi, lo), torch.where(swap, lo, hi)), dim=1))


class _Butterfly:
    """The K9 library (built with nvcc at its first launch) and its launch
    count: ``launches`` grows by one per permute that runs the kernel."""

    def __init__(self):
        self._lib = None
        self.build_dir: Optional[str] = None
        self.launches = 0

    @property
    def source(self) -> str:
        """The kernel's CUDA source (``csrc/benes.cu``)."""
        with open(os.path.join(_CSRC, "benes.cu")) as f:
            return f.read()

    def build(self):
        """Build (nvcc, once per source) and load the library; also what
        ``compiled_program.build_all`` calls to build it beside the
        stencils."""
        if self._lib is None:
            from gt4py_tpu_torch.cartesian.backend import _build

            lib, self.build_dir = _build.build(self.source, "benes")
            lib.benes_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
            lib.benes_permute.restype = ctypes.c_int
            lib.benes_error_string.argtypes = [ctypes.c_int]
            lib.benes_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, x: torch.Tensor, plan: Plan) -> None:
        """Run the network in place on ``x`` (n2 contiguous int32 words on
        a CUDA device)."""
        if not (x.is_cuda and x.dtype == torch.int32 and x.is_contiguous()
                and x.numel() == plan.n2):
            raise ValueError("K9 takes n2 contiguous int32 words on a CUDA device")
        lib = self.build()
        bits = plan.device_bits(x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.benes_permute(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(bits.data_ptr()),
                                   plan.k, plan.b, plan.bits.shape[1], ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"K9 launch failed: {lib.benes_error_string(rc).decode()} "
                               f"(error {rc})")
        self.launches += 1


#: the K9 kernel's wrapper
KERNEL = _Butterfly()


def _decline(reason: str, detail) -> None:
    DECLINES.record((reason, detail))
    return None


def permute(vals: torch.Tensor, keys_np: np.ndarray) -> Optional[torch.Tensor]:
    """Static permutation ``dest[j] = src[keys^-1(j)]`` of a 1-D tensor
    through the network: K9 on a CUDA tensor, the plain version on a CPU
    tensor.  None (recorded in ``DECLINES``) for another rank or dtype or
    a padded size above ``2**_MAX_LOG2``.  Values move as raw 32-bit
    words, so every bit pattern survives."""
    if vals.ndim != 1:
        return _decline("ndim", vals.ndim)
    if vals.dtype not in _ELIGIBLE:
        return _decline("dtype", str(vals.dtype))
    if keys_np.shape != (vals.shape[0],):
        raise ValueError(f"{keys_np.shape[0]} keys for {vals.shape[0]} values")
    plan = _plan(keys_np)
    if plan is None:
        return _decline("size", vals.shape[0])
    P = plan.P
    x = torch.empty(plan.n2, dtype=torch.int32, device=vals.device)
    x[:P].copy_(vals.view(torch.int32))
    x[P:].zero_()
    if x.is_cuda:
        KERNEL.launch(x, plan)
    elif x.device.type == "cpu":
        plain_inplace(x, plan)
    else:
        raise ValueError(f"benes.permute takes CPU or CUDA tensors, got {x.device}")
    return x[:P].view(vals.dtype)
