"""Beneš-network static permutations: the host router and the K9 kernel.

The counterpart of ``gt4py_tpu.next.benes``.  A static permutation
``y[i] = x[perm[i]]`` on n = 2^k elements factors into 2k-1 butterfly
exchange stages (distances n/2, ..., 2, 1, 2, ..., n/2; pairs (i, i^d)
swap or pass).  Routing the control bits is a 2-colouring done once per
permutation on the host (``csrc/benes_router.cpp``, built with g++ into
``config.BUILD_DIR`` at first use); applying them is pure data movement:

- on CUDA tensors, the K9 kernel (``csrc/benes.cu``, built with nvcc at
  first use): three launches (``_passes``) -- the first side's outer
  stages on rows of 2^c-word segments, every stage below the 2^b-word
  block, the second side's outer stages -- each CTA holding its words in
  registers (stages on register bits inside a thread, on lane bits by
  warp shuffles, re-laid through shared memory between, as
  ``_program`` plans) and its control bits staged in shared memory; one
  launch when k = b (``layout`` chooses b and c per size);
- on CPU tensors, the plain version (``plain_inplace``): stage by stage,
  one ``torch.where`` over the pairs, from the router's bits one per pair
  (``pair_planes``), independent of the kernel's passes and packing.

A permutation is differentiable: the backward pass routes the cotangent
through the inverse permutation on the same network (a second plan, routed
at the first backward and kept beside the forward one), so the gradient of
a routed gather launches K9 in both directions.

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
from gt4py_tpu_torch.cartesian.backend.torch_backend import wants_derivative
from gt4py_tpu_torch.core.events import EventLog

#: log2 of the most words one pass's CTA holds (``kMaxLog2`` in
#: ``csrc/benes.cu``: 16 registers of 1024 threads)
_MAX_BLOCK_LOG2 = 14
#: a pass program's most ops and layouts (``kMaxOps``, ``kMaxLayouts``)
_MAX_OPS, _MAX_LAYOUTS = 64, 16
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


def _passes(k: int, b: int, c: int) -> list:
    """The launches of the network on 2^k words with an inner block of
    2^b words and outer row segments of 2^c words (``csrc/benes.cu``):
    ``(m, c, stages, local_bits, ncta)`` per pass -- the pass's CTA takes
    2^m local words, local word ``L`` being global index
    ``((L >> c) << b) | (cta << c) | (L & (2^c - 1))``; ``stages`` are the
    network's stage indices it applies, ``local_bits`` the local bit each
    exchanges.  One pass (the inner form over everything) when k = b, else
    the first side's outer stages, the inner ones, the second side's."""
    inner_bits = [b - 1 - s if s < b else s - b + 1 for s in range(2 * b - 1)]
    if k == b:
        return [(b, b, list(range(2 * k - 1)), inner_bits, 1)]
    r = k - b
    return [
        (r + c, c, list(range(r)), [c + r - 1 - s for s in range(r)], 1 << (b - c)),
        (b, b, list(range(r, r + 2 * b - 1)), inner_bits, 1 << r),
        (r + c, c, list(range(r + 2 * b - 1, 2 * k - 1)), [c + s for s in range(r)],
         1 << (b - c)),
    ]


def _local_to_global(m: int, c: int, b: int, ncta: int) -> np.ndarray:
    """(ncta, 2^m) global index of every CTA's local words."""
    L = np.arange(1 << m, dtype=np.int64)
    g = np.arange(ncta, dtype=np.int64)
    return ((L >> c) << b)[None, :] | (g << c)[:, None] | (L & ((1 << c) - 1))[None, :]


#: log2 of the registers a thread holds in a pass: with 16, K9 took
#: 0.0231-0.0249 ms of device time at 2^20 words against 0.0277-0.0299
#: with 8, and about as long at 2^19, in every layout timed on the H100
#: (``chip_smoke.py --k9-layouts``, PERF.md)
_REG_LOG2 = 4


def _thread_shape(m: int):
    """``(lane bits, e, threads)`` of a pass over 2^m local words (m at
    most ``_MAX_BLOCK_LOG2``): local bits 0..4 are a thread's lane (fewer
    below 32 words), e bits its register among 2^e (``_REG_LOG2``, fewer
    where the pass has fewer words), the rest its warp."""
    lb = min(5, m)
    rest = m - lb
    e = min(rest, _REG_LOG2)
    return lb, e, 32 << (rest - e)


def _program(m: int, local_bits: list):
    """A pass's layouts (each a sorted list of e register bits) and ops,
    ``(kind, arg)`` in order: kind 0 a stage on the register bit at
    position arg of the current layout, 1 a stage on lane bit arg, 2 a
    re-lay to layout arg.  A stage on a warp bit first re-lays to the next
    e distinct non-lane bits the stages reach (the pass starts in layout
    0)."""
    lb, e, _ = _thread_shape(m)
    layouts, ops, cur = [], [], None
    for n, p in enumerate(local_bits):
        if p < lb:
            ops.append((1, p))
            continue
        if cur is None or p not in cur:
            want = []
            for q in local_bits[n:]:
                if q >= lb and q not in want:
                    want.append(q)
                if len(want) == e:
                    break
            want += [q for q in range(lb, m) if q not in want][: e - len(want)]
            if cur is not None:
                ops.append((2, len(layouts)))
            cur = sorted(want)
            layouts.append(cur)
        ops.append((0, cur.index(p)))
    if not layouts:
        layouts.append(list(range(lb, lb + e)))
    return layouts, ops


def _addresses(m: int, rb: list):
    """(threads, 2^e) local word of each thread's registers in the layout
    with register bits ``rb`` (e = len(rb)), and which threads hold words
    (lanes beyond 2^m idle)."""
    lb, e = min(5, m), len(rb)
    T = 32 << (m - lb - e)
    t = np.arange(T, dtype=np.int64)
    lane, warp = t & 31, t >> 5
    base = lane.copy()
    for j, p in enumerate(q for q in range(lb, m) if q not in rb):
        base |= ((warp >> j) & 1) << p
    slot = np.arange(1 << e, dtype=np.int64)
    regs = np.zeros(1 << e, dtype=np.int64)
    for i, p in enumerate(rb):
        regs |= ((slot >> i) & 1) << p
    return base[:, None] | regs[None, :], lane < (1 << lb)


class _Prog(ctypes.Structure):
    """A pass's program as the kernel takes it (``Prog`` in
    ``csrc/benes.cu``): e, the ops, each layout's register bits."""

    _fields_ = [("e", ctypes.c_int), ("n_ops", ctypes.c_int),
                ("rb", (ctypes.c_ubyte * 5) * _MAX_LAYOUTS),
                ("wb", (ctypes.c_ubyte * 5) * _MAX_LAYOUTS),
                ("op", ctypes.c_ubyte * _MAX_OPS)]


def _prog(m: int, layouts: list, ops: list) -> _Prog:
    if len(ops) > _MAX_OPS or len(layouts) > _MAX_LAYOUTS:
        raise ValueError(f"benes pass over 2^{m} words: {len(ops)} ops, {len(layouts)} layouts")
    prog = _Prog()
    prog.e = len(layouts[0])
    prog.n_ops = len(ops)
    for n, rb in enumerate(layouts):
        for i, p in enumerate(rb):
            prog.rb[n][i] = p
        for j, p in enumerate(q for q in range(min(5, m), m) if q not in rb):
            prog.wb[n][j] = p
    for n, (kind, arg) in enumerate(ops):
        prog.op[n] = (kind << 6) | arg
    return prog


def _stage_words(m: int, e: int, n_stages: int):
    """(32-bit words a thread, threads) of a pass's control bits: 2^e bits
    per thread and stage, in order."""
    return (n_stages * (1 << e) + 31) // 32, 32 << (m - min(5, m) - e)


def pair_planes(ctrl: np.ndarray) -> np.ndarray:
    """(2k-1, n) router bits -> (2k-1, words) uint32 bit-planes, one bit per
    pair: pair q of the stage at distance d (lower member i, bit log2(d) of
    i clear, pairs numbered in increasing i) is bit q % 32 of word q // 32.
    ``words = max(1, n // 64)``.  What the plain version reads."""
    n_stages, n = ctrl.shape
    k = int(n).bit_length() - 1
    words = max(1, n // 64)
    out = np.zeros((n_stages, words * 4), dtype=np.uint8)
    for s, d in enumerate(stage_distances(k)):
        lower = ctrl[s].reshape(n // (2 * d), 2, d)[:, 0, :].reshape(-1)
        packed = np.packbits(lower.astype(np.uint8), bitorder="little")
        out[s, : packed.size] = packed
    return out.view("<u4").astype(np.uint32)


def pack_pair_bits(ctrl: np.ndarray, b: int, c: int):
    """(2k-1, n) router bits -> ``(bits, offsets)``: one uint32 array with
    each pass's control bits (``_passes``) and the word offset of each
    pass's region (a multiple of 4 words, so every CTA's block is 16-byte
    aligned).  In a pass over 2^m words a thread holds 2^e words
    (``_thread_shape``); for each stage, in order, it takes 2^e bits, bit s
    the router's bit of its register s's word (which the word's pair
    partner shares), in the layout ``_program`` gives that stage; the bits
    stream into 32-bit words.  A pass's region is CTA-major, each CTA's
    block word-major: thread t's word w at ``w * threads + t``, so a CTA
    stages its block with one contiguous copy and thread t reads its words
    without bank conflicts."""
    n = ctrl.shape[1]
    k = int(n).bit_length() - 1
    regions, offsets, at = [], [], 0
    for m, cc, stages, local_bits, ncta in _passes(k, b, c):
        G = _local_to_global(m, cc, b, ncta)
        layouts, ops = _program(m, local_bits)
        e = len(layouts[0])
        nw, T = _stage_words(m, e, len(stages))
        E = 1 << e
        words = np.zeros((ncta, T, nw), dtype=np.uint32)
        addr, valid = _addresses(m, layouts[0])
        t = 0
        for kind, arg in ops:
            if kind == 2:
                addr, valid = _addresses(m, layouts[arg])
                continue
            got = ctrl[stages[t]][G[:, np.where(valid[:, None], addr, 0)]].astype(np.uint32)
            got[:, ~valid, :] = 0
            val = (got << np.arange(E, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)
            words[:, :, (t * E) >> 5] |= val << np.uint32((t * E) & 31)
            t += 1
        words = words.transpose(0, 2, 1).reshape(-1)
        pad = -words.size % 4
        regions.append(np.concatenate([words, np.zeros(pad, np.uint32)]))
        offsets.append(at)
        at += words.size + pad
    return np.concatenate(regions), offsets


def layout(k: int):
    """``(b, c)`` of a permute on 2^k words: the inner block 2^b and the
    outer passes' row segment 2^c.  Up to 2^11 words one launch (b = k).
    Above, b = k - 8 within [11, 13], so the FVM's 2^19-2^20 permutes run
    256 inner CTAs of 2^11-2^12 words (the H100 has 132 SMs); c makes the
    outer passes' CTAs 2^11 words (rows of at least 8 words, one 32-byte
    sector): 256-512 CTAs at 2^19-2^20.  At 2^24 (b = 13, c = 3) a pass A
    or C CTA holds 2^14 words.  Of the layouts ``chip_smoke.py`` phase 8
    times on the H100, these were the fastest or within 3 % of it."""
    if k <= 11:
        return k, k
    b = min(13, max(11, k - 8))
    return b, min(b, max(3, 11 - (k - b)))


class Plan:
    """A routed permutation: ``dest[j] = src[sigma(j)]`` for j < P on the
    padded size n2 = 2^k (identity on the tail), with its packed bits and
    pass programs for the layout ``(b, c)`` (``layout(k)`` unless given);
    the device copy of the bits is made at the first launch on each
    device; and the router's bits one per pair (``pair_planes``) for the
    plain version.  ``launches``: the kernel launches one permute plans (3,
    or 1 when k = b; ``_Butterfly.device_launches`` counts those made)."""

    def __init__(self, P: int, k: int, ctrl: np.ndarray, b: Optional[int] = None,
                 c: Optional[int] = None):
        self.P = P
        self.k = k
        self.n2 = 1 << k
        lb, lc = layout(k)
        # a block above the size is the size: one pass
        self.b = lb if b is None else min(b, k)
        self.c = lc if c is None else min(c, self.b)
        if not (1 <= self.b <= min(k, _MAX_BLOCK_LOG2) and 0 <= self.c <= self.b
                and (self.b == k or k - self.b + self.c <= _MAX_BLOCK_LOG2)):
            raise ValueError(f"benes layout b={self.b}, c={self.c} does not fit k={k}")
        self.bits, self.offsets = pack_pair_bits(ctrl, self.b, self.c)
        self.pair_bits = pair_planes(ctrl)
        self.passes = _passes(k, self.b, self.c)
        self.programs = [_program(p[0], p[3]) for p in self.passes]
        self._progs = [_prog(p[0], *prog) for p, prog in zip(self.passes, self.programs)]
        self.launches = len(self.passes)
        self._device_bits = {}
        self._launch_args = {}
        #: the plan of the inverse permutation (``_inverse_plan``)
        self.inverse: Optional["Plan"] = None

    def record(self) -> dict:
        """The plan as the chip check prints it."""
        return {"P": self.P, "k": self.k, "b": self.b, "c": self.c,
                "launches": self.launches,
                "ctas": [p[4] for p in self.passes],
                "words_per_cta": [1 << p[0] for p in self.passes],
                "registers": [1 << len(prog[0][0]) for prog in self.programs],
                "threads": [_thread_shape(p[0])[2] for p in self.passes],
                "stages": [len(p[2]) for p in self.passes],
                "relayouts": [sum(op == 2 for op, _ in prog[1]) for prog in self.programs],
                "bits_bytes": int(self.bits.nbytes)}

    def device_bits(self, device) -> torch.Tensor:
        t = self._device_bits.get(device)
        if t is None:
            t = torch.from_numpy(self.bits.view(np.int32)).to(device)
            self._device_bits[device] = t
        return t

    def launch_args(self, device) -> tuple:
        """``benes_permute``'s bits and programs of each pass (the inner
        pass's three times when k = b) and k, b, c, for ``device``."""
        hit = self._launch_args.get(device)
        if hit is None:
            base = self.device_bits(device).data_ptr()
            regions = [base + 4 * off for off in self.offsets]
            progs = [ctypes.addressof(p) for p in self._progs]
            if len(regions) == 1:
                regions, progs = regions * 3, progs * 3
            hit = self._launch_args[device] = (*regions, *progs, self.k, self.b, self.c)
        return hit


_plan_cache: dict = {}
_PLAN_CACHE_MAX = 256


def _route_plan(sigma_p: np.ndarray, b: Optional[int] = None,
                c: Optional[int] = None) -> Plan:
    """Route ``dest[j] = src[sigma_p(j)]`` on P elements, padded to the next
    power of two with the identity; ``b``, ``c``: the layout (default
    ``layout(k)``)."""
    P = sigma_p.shape[0]
    k = max(1, int(P - 1).bit_length())
    sigma = np.empty(1 << k, dtype=np.int64)
    sigma[:P] = sigma_p
    sigma[P:] = np.arange(P, 1 << k, dtype=np.int64)  # identity tail
    return Plan(P, k, route(sigma), b, c)


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
    if max(1, int(P - 1).bit_length()) > _MAX_LOG2:
        return None
    inv = np.empty(P, dtype=np.int64)
    inv[keys_np] = np.arange(P, dtype=np.int64)
    plan = _route_plan(inv)
    if len(_plan_cache) >= _PLAN_CACHE_MAX:
        _plan_cache.clear()
    _plan_cache[token] = plan
    return plan


def _inverse_plan(plan: Plan, keys_np: np.ndarray) -> Plan:
    """The plan of sigma^-1 (``dest[i] = src[keys(i)]``, in ``plan``'s
    layout), which carries a cotangent back through ``plan``: routed the
    first time a backward pass needs it and kept on ``plan``."""
    if plan.inverse is None:
        plan.inverse = _route_plan(keys_np.astype(np.int64), plan.b, plan.c)
    return plan.inverse


# --------------------------------------------------------------------------- #
# the kernel and its plain version
# --------------------------------------------------------------------------- #


def plain_inplace(x: torch.Tensor, plan: Plan) -> None:
    """The plain butterfly on ``x`` (n2 int32 words), in place: every stage
    as one ``torch.where`` over the pairs, from the plan's bits one per
    pair (``Plan.pair_bits``)."""
    n2 = plan.n2
    bits = torch.from_numpy(plan.pair_bits.view(np.int32)).to(x.device)
    q = torch.arange(n2 // 2, device=x.device)
    for s, d in enumerate(stage_distances(plan.k)):
        words = bits[s][q >> 5]
        swap = ((words >> (q & 31).to(torch.int32)) & 1).bool().reshape(n2 // (2 * d), d)
        pairs = x.view(n2 // (2 * d), 2, d)
        lo, hi = pairs[:, 0, :], pairs[:, 1, :]
        pairs.copy_(torch.stack((torch.where(swap, hi, lo), torch.where(swap, lo, hi)), dim=1))


class _Butterfly:
    """The K9 library (built with nvcc at its first launch) and its launch
    counts: ``launches`` grows by one per permute that runs the kernel;
    ``device_launches`` is the library's own count of the kernel launches
    it has made, counted at each launch."""

    def __init__(self):
        self._lib = None
        self.build_dir: Optional[str] = None
        self.launches = 0

    @property
    def source(self) -> str:
        """The kernel's CUDA source (``csrc/benes.cu``)."""
        with open(os.path.join(_CSRC, "benes.cu")) as f:
            return f.read()

    @property
    def device_launches(self) -> int:
        """Kernel launches the library has made since it was loaded (0
        before it is built)."""
        return int(self._lib.benes_device_launches()) if self._lib is not None else 0

    def build(self):
        """Build (nvcc, once per source) and load the library; also what
        ``compiled_program.build_all`` calls to build it beside the
        stencils."""
        if self._lib is None:
            from gt4py_tpu_torch.cartesian.backend import _build

            lib, self.build_dir = _build.build(self.source, "benes")
            lib.benes_permute.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                          ctypes.c_void_p] + [ctypes.c_void_p] * 6 + [
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
            lib.benes_permute.restype = ctypes.c_int
            lib.benes_error_string.argtypes = [ctypes.c_int]
            lib.benes_error_string.restype = ctypes.c_char_p
            lib.benes_device_launches.argtypes = []
            lib.benes_device_launches.restype = ctypes.c_ulonglong
            self._lib = lib
        return self._lib

    def launch(self, words: torch.Tensor, plan: Plan) -> torch.Tensor:
        """The permutation of ``words`` (P contiguous int32 words on a CUDA
        device) into a new tensor of P words."""
        if not (words.is_cuda and words.dtype == torch.int32 and words.is_contiguous()
                and words.numel() == plan.P):
            raise ValueError("K9 takes P contiguous int32 words on a CUDA device")
        return self._launch(words, plan)

    def _launch(self, words: torch.Tensor, plan: Plan) -> torch.Tensor:
        """The launch itself (a host build of the kernel runs it on CPU
        tensors in the tests)."""
        lib = self._lib or self.build()
        device = words.device
        out = torch.empty(plan.P, dtype=torch.int32, device=device)
        # the inner pass's n2 words (the outer passes read and write the
        # caller's P words and the result's directly)
        tmp = torch.empty(plan.n2, dtype=torch.int32, device=device) \
            if plan.launches > 1 else out
        args = (words.data_ptr(), plan.P, tmp.data_ptr(), out.data_ptr(),
                *plan.launch_args(device))
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.type == "cuda" and device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                rc = lib.benes_permute(*args, stream)
        else:
            rc = lib.benes_permute(*args, stream)
        if rc != 0:
            raise RuntimeError(f"K9 launch failed: {lib.benes_error_string(rc).decode()} "
                               f"(error {rc})")
        self.launches += 1
        return out


#: the K9 kernel's wrapper
KERNEL = _Butterfly()


def _decline(reason: str, detail) -> None:
    DECLINES.record((reason, detail))
    return None


def _run(vals: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``plan``'s permutation of ``vals`` as raw 32-bit words: K9 on a CUDA
    tensor (the passes read ``vals`` and write the result, no padded
    copy), the plain version on a padded copy of a CPU tensor."""
    words = vals.contiguous().view(torch.int32)
    if words.is_cuda:
        return KERNEL.launch(words, plan).view(vals.dtype)
    if words.device.type != "cpu":
        raise ValueError(f"benes.permute takes CPU or CUDA tensors, got {words.device}")
    x = torch.zeros(plan.n2, dtype=torch.int32)
    x[: plan.P] = words
    plain_inplace(x, plan)
    return x[: plan.P].view(vals.dtype)


class _Permute(torch.autograd.Function):
    """``dest[j] = src[sigma(j)]`` as a differentiable operation: the
    cotangent of ``dest`` goes back through sigma^-1 on the same network
    (K9 again on the card), the tangent through sigma."""

    @staticmethod
    def forward(vals, plan, keys_np):
        return _run(vals, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.keys = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _run(grad.contiguous(), _inverse_plan(ctx.plan, ctx.keys)), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _run(tangent.contiguous(), ctx.plan)


def permute(vals: torch.Tensor, keys_np: np.ndarray) -> Optional[torch.Tensor]:
    """Static permutation ``dest[j] = src[keys^-1(j)]`` of a 1-D tensor
    through the network: K9 on a CUDA tensor, the plain version on a CPU
    tensor.  None (recorded in ``DECLINES``) for another rank or dtype or
    a padded size above ``2**_MAX_LOG2``.  Values move as raw 32-bit
    words, so every bit pattern survives.  When a derivative is wanted the
    call is differentiable (``_Permute``); otherwise it runs as it is."""
    if vals.ndim != 1:
        return _decline("ndim", vals.ndim)
    if vals.dtype not in _ELIGIBLE:
        return _decline("dtype", str(vals.dtype))
    if keys_np.shape != (vals.shape[0],):
        raise ValueError(f"{keys_np.shape[0]} keys for {vals.shape[0]} values")
    plan = _plan(keys_np)
    if plan is None:
        return _decline("size", vals.shape[0])
    if wants_derivative([vals]):
        return _Permute.apply(vals, plan, keys_np)
    return _run(vals, plan)
