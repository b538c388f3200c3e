"""Stencils that hold the generated kernels to the plain executor.

Used by the card tests (``tests/test_torch_cuda.py``) and the chip check
(``chip_smoke.py``), which run where JAX is not installed:

- ``load_stencil_defs()``: the repository's canonical stencil registry,
  ``tests/cartesian/stencil_defs.py``, with its two imports of the JAX
  package's ``gtscript`` and ``Registry`` pointed at the port.  Nothing of
  ``gt4py_tpu`` is imported.
- ``SURFACE``: the language features the TPU kernels run in-kernel and the
  registry covers only in part -- absolute K (``.at(K=...)``) from a
  literal, a scalar and a 2D field, absolute and variable K inside scans,
  data dimensions of rank 2 with constant and per-point writes, float16
  and bfloat16 storage in the row and the column form.
- ``run_pair()``: one definition on ``"cuda"`` and on ``"torch"`` over the
  same inputs on one device.
- ``plain_form()``: K5's plain counterpart, the plain executor on the
  stencil the kernels were planned on (the serialized one);
  ``plain_kblocked()``: K4's, the K-blocked passes run block by block
  through the plain executor.
"""

import linecache
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STENCIL_DEFS = os.path.join(ROOT, "tests", "cartesian", "stencil_defs.py")

#: import lines of the registry module and their port counterparts (each
#: replacement keeps the line count, so definitions keep their lines)
_IMPORTS = (
    ("from gt4py_tpu.cartesian import gtscript",
     "from gt4py_tpu_torch.cartesian import gtscript"),
    ("from gt4py_tpu.cartesian.gtscript import (",
     "from gt4py_tpu_torch.cartesian.gtscript import ("),
    ("from gt4py_tpu.utils import Registry", "Registry = dict"),
)


def load_stencil_defs(path: str = STENCIL_DEFS) -> Dict[str, dict]:
    """The registry of ``tests/cartesian/stencil_defs.py`` on the port:
    name -> ``dict(definition, make_inputs, externals, domain, origin)``."""
    with open(path) as f:
        src = f.read()
    for old, new in _IMPORTS:
        if old not in src:
            raise ValueError(f"{path}: expected the line {old!r}")
        src = src.replace(old, new)
    if "gt4py_tpu." in src:
        raise ValueError(f"{path}: an import of the JAX package is left")
    filename = f"<port:{os.path.basename(path)}>"
    # the frontend reads each definition's source through linecache
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns: dict = {"__name__": "gt4py_tpu_torch_stencil_defs"}
    exec(compile(src, filename, "exec", dont_inherit=True), ns)
    return dict(ns["REGISTRY"])


# --------------------------------------------------------------------------- #
# features beyond the registry
# --------------------------------------------------------------------------- #

F64 = gtscript.Field[np.float64]
I64 = gtscript.Field[np.int64]


def at_k_literal(a: F64, out: F64):
    with computation(PARALLEL), interval(...):
        out = a.at(K=2) + a[0, 0, 0]


def at_k_scalar(a: F64, out: F64, *, kidx: int):
    with computation(PARALLEL), interval(...):
        out = a.at(K=kidx)


def at_k_field(a: F64, kidx: gtscript.Field[gtscript.IJ, np.int64], out: F64):
    with computation(PARALLEL), interval(...):
        out = a.at(K=kidx) * 2.0


def at_k_in_scan(a: F64, out: F64):
    with computation(FORWARD):
        with interval(0, 1):
            out = a.at(K=3)
        with interval(1, None):
            out = a.at(K=0) + out[0, 0, -1]


def variable_k_in_scan(a: F64, kidx: I64, acc: F64):
    with computation(BACKWARD), interval(...):
        acc = a[0, 0, kidx] + acc[0, 0, 1] * 0.5


def variable_k_after_write(a: F64, kidx: I64, out: F64):
    with computation(PARALLEL), interval(1, None):
        t = a * 2.0
    with computation(PARALLEL), interval(...):
        out = t[0, 0, kidx] + t[1, 0, 0]


def data_dims_writes(vec: gtscript.Field[(np.float64, (3,))], out: F64,
                     w: gtscript.Field[(np.float64, (2, 2))]):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][0] + vec[1, 0, 0][1] * vec[0, 0, 0][2]
        w[0, 0, 0][1, 0] = out[0, 0, 0] * 2.0
        w[0, 0, 0][0, 1] = vec[0, 0, 0][-1]


def data_dims_dynamic_write(vec: gtscript.Field[(np.float64, (3,))], idx: I64, a: F64,
                            out: F64):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][idx % 3] + a[1, 0, 0]
        vec[0, 0, 0][(idx + 1) % 3] = a * 2.0


F16 = gtscript.Field[np.float16]


def float16_hdiff_sweep(inp: F16, coeff: F16, out: F16, col: F16):
    with computation(PARALLEL), interval(...):
        lap = 4.0 * inp[0, 0, 0] - (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])
        res = lap[1, 0, 0] - lap[0, 0, 0]
        flx = 0 if (res * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res
        res = lap[0, 1, 0] - lap[0, 0, 0]
        fly = 0 if (res * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res
        out = inp[0, 0, 0] - coeff[0, 0, 0] * (flx[0, 0, 0] - flx[-1, 0, 0]
                                               + fly[0, 0, 0] - fly[0, -1, 0])
    with computation(FORWARD):
        with interval(0, 1):
            col = out[0, 0, 0]
        with interval(1, None):
            col = 0.5 * col[0, 0, -1] + out[0, 0, 0]


BF16 = gtscript.Field[gtscript.bfloat16]


def bfloat16_hdiff_sweep(inp: BF16, coeff: BF16, out: BF16, col: BF16):
    with computation(PARALLEL), interval(...):
        lap = 4.0 * inp[0, 0, 0] - (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])
        res = lap[1, 0, 0] - lap[0, 0, 0]
        flx = 0 if (res * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res
        res = lap[0, 1, 0] - lap[0, 0, 0]
        fly = 0 if (res * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res
        out = inp[0, 0, 0] - coeff[0, 0, 0] * (flx[0, 0, 0] - flx[-1, 0, 0]
                                               + fly[0, 0, 0] - fly[0, -1, 0])
    with computation(FORWARD):
        with interval(0, 1):
            col = out[0, 0, 0]
        with interval(1, None):
            col = 0.5 * col[0, 0, -1] + out[0, 0, 0]


def _rng(seed):
    return np.random.default_rng(seed)


#: name -> (definition, make_inputs() -> (fields, scalars), call keywords)
SURFACE: Dict[str, Tuple[Callable, Callable, dict]] = {
    "at_k_literal": (at_k_literal, lambda: (
        dict(a=_rng(1).random((6, 5, 7)), out=np.zeros((6, 5, 7))), {}), {}),
    "at_k_scalar": (at_k_scalar, lambda: (
        dict(a=_rng(2).random((6, 5, 7)), out=np.zeros((6, 5, 7))), dict(kidx=9)), {}),
    "at_k_field": (at_k_field, lambda: (
        dict(a=_rng(3).random((6, 5, 7)), kidx=_rng(4).integers(-2, 9, (6, 5)),
             out=np.zeros((6, 5, 7))), {}), {}),
    "at_k_in_scan": (at_k_in_scan, lambda: (
        dict(a=_rng(5).random((7, 9, 8)), out=np.zeros((7, 9, 8))), {}), {}),
    "variable_k_in_scan": (variable_k_in_scan, lambda: (
        dict(a=_rng(6).random((6, 7, 10)), kidx=_rng(7).integers(-9, 10, (6, 7, 10)),
             acc=np.zeros((6, 7, 10))), {}), dict(domain=(6, 7, 9))),
    "variable_k_after_write": (variable_k_after_write, lambda: (
        dict(a=_rng(8).random((9, 6, 8)), kidx=_rng(9).integers(-3, 4, (9, 6, 8)),
             out=np.zeros((9, 6, 8))), {}), dict(domain=(8, 6, 8))),
    "data_dims_writes": (data_dims_writes, lambda: (
        dict(vec=_rng(10).random((6, 5, 4, 3)), out=np.zeros((6, 5, 4)),
             w=np.zeros((6, 5, 4, 2, 2))), {}), dict(origin=(1, 0, 0), domain=(4, 5, 4))),
    "data_dims_dynamic_write": (data_dims_dynamic_write, lambda: (
        dict(vec=_rng(11).random((6, 5, 4, 3)), idx=_rng(12).integers(-5, 6, (6, 5, 4)),
             a=_rng(13).random((6, 5, 4)), out=np.zeros((6, 5, 4))), {}),
        dict(origin=(1, 0, 0), domain=(4, 5, 4))),
    "float16_hdiff_sweep": (float16_hdiff_sweep, lambda: (
        dict(inp=_rng(14).random((12, 11, 6)).astype(np.float16),
             coeff=(0.025 * _rng(15).random((12, 11, 6))).astype(np.float16),
             out=np.zeros((12, 11, 6), np.float16), col=np.zeros((12, 11, 6), np.float16)), {}),
        dict(origin=(2, 2, 0), domain=(8, 7, 6))),
    # numpy has no bfloat16: float32 inputs, rounded to the fields' dtype
    # on the way in (``run_pair``)
    "bfloat16_hdiff_sweep": (bfloat16_hdiff_sweep, lambda: (
        dict(inp=_rng(16).random((12, 11, 6)).astype(np.float32),
             coeff=(0.025 * _rng(17).random((12, 11, 6))).astype(np.float32),
             out=np.zeros((12, 11, 6), np.float32), col=np.zeros((12, 11, 6), np.float32)), {}),
        dict(origin=(2, 2, 0), domain=(8, 7, 6))),
}


def registry_case(entry: dict) -> Tuple[Callable, Callable, dict]:
    """A ``load_stencil_defs()`` entry as a ``SURFACE``-style case."""

    def make_inputs():
        inputs = entry["make_inputs"]()
        fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
        return fields, {k: v for k, v in inputs.items() if k not in fields}

    kw = {k: entry[k] for k in ("origin", "domain") if entry[k] is not None}
    return entry["definition"], make_inputs, dict(kw, externals=entry["externals"])


def run_pair(definition, make_inputs, kw: dict, device) -> Tuple[dict, dict, object]:
    """Build ``definition`` on ``"cuda"`` and ``"torch"`` and call both on
    the same inputs, as tensors on ``device``.  Returns the fields after
    each call and the ``"cuda"`` stencil object (its ``backend.launches``
    counts the calls that launched its kernels)."""
    kw = dict(kw)
    externals = kw.pop("externals", {})
    out, cuda_stencil = {}, None
    for backend in ("cuda", "torch"):
        st = gtscript.stencil(backend=backend, definition=definition, externals=externals,
                              rebuild=True)
        fields, scalars = make_inputs()
        tensors = {k: dtypes.cast(torch.from_numpy(np.ascontiguousarray(v)),
                                  st.field_info[k].dtype).to(device)
                   for k, v in fields.items()}
        st(**tensors, **scalars, **kw)
        out[backend] = tensors
        if backend == "cuda":
            cuda_stencil = st
    return out["cuda"], out["torch"], cuda_stencil


def plain_form(st):
    """A copy of the ``"cuda"`` stencil object ``st`` whose calls run the
    plain executor on the stencil its kernels were planned on: the
    serialized one when ``st`` runs serialized (K5)."""
    import copy

    from gt4py_tpu_torch.cartesian.backend.torch_backend import TorchBackend

    out = copy.copy(st)
    out.backend = TorchBackend(st.backend.program.analysis)
    return out


def plain_kblocked(st, fields: Dict[str, torch.Tensor], scalars: dict, origin, domain,
                   periodic=()) -> None:
    """K4's plain counterpart on ``fields`` (logical (I, J, K) tensors, the
    written ones filled in place): ``passes.split_serial_passes``'s passes
    of the ``"cuda"`` stencil ``st`` in order through the plain executor,
    each column-form loop once per K block (``passes.
    clip_stencil_to_k_block``, the blocks and their sizes K4 takes at this
    depth, in the loop's order), the promoted temporaries in zeroed
    buffers.  Raises when K4 does not run at this depth."""
    from gt4py_tpu_torch.cartesian import ir, passes
    from gt4py_tpu_torch.cartesian.analysis import analyze
    from gt4py_tpu_torch.cartesian.backend.torch_backend import (
        TorchExecutor,
        has_horizontal_reads,
        periodic_fill,
    )

    prog = st.backend.program
    dI, dJ, dK = domain
    kbs, declined = prog.kblock_plan(dI * dJ, dK)
    if kbs is None:
        raise ValueError(f"K4 does not run '{st.name}' at depth {dK}: {declined}")
    an = prog.analysis
    env = dict(fields)
    origins = {n: tuple(origin) for n in env}
    if periodic:
        names = [n for n in env if has_horizontal_reads(an, n)]
        for n in names:
            if not an.field_info[n].access.value & 2:
                env[n] = env[n].clone()
        periodic_fill(an, env, domain, origins, periodic, names)
    pass_stencils, promoted = passes.split_serial_passes(an.stencil)
    device = next(iter(env.values())).device
    for n in promoted:
        e = an.extents.alloc_extent(n)
        env[n] = torch.zeros((dI, dJ, dK - e.k[0] + e.k[1]),
                             dtype=dtypes.to_torch(an.stencil.temp_decls[n].dtype), device=device)
        origins[n] = (0, 0, -e.k[0])
    # one block size per serial loop: K4's for a column-form loop, the whole
    # depth for a plane-sweep one
    sizes = iter(kbs)
    serial = [next(sizes) if k.form == "columns" else dK for k in prog.kernels
              if k.form != "rows"]
    for pst in pass_stencils:
        (loop,) = pst.vertical_loops
        names = [n for n in pst.field_decls if n in env]
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            TorchExecutor(analyze(pst)).run({n: env[n] for n in names}, scalars, domain,
                                            {n: origins[n] for n in names})
            continue
        kb = serial.pop(0)
        blocks = [(b, min(b + kb, dK)) for b in range(0, dK, kb)]
        if loop.loop_order == ir.LoopOrder.BACKWARD:
            blocks.reverse()
        for b0, b1 in blocks:
            bst = passes.clip_stencil_to_k_block(pst, b0, b1, dK, scalars)
            if bst is None:
                continue
            shifted = {n: (origins[n][0], origins[n][1], origins[n][2] + b0) for n in names}
            TorchExecutor(analyze(bst)).run({n: env[n] for n in names}, scalars,
                                            (dI, dJ, b1 - b0), shifted)
