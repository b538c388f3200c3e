"""The distributed layer's cases, run on every rank of a job of gloo ranks.

``launch(cases, ...)`` starts the ranks (``torch.multiprocessing``, start
method ``spawn``, a file store in ``workdir``), each rank runs every case
of ``cases`` (name -> keyword parameters) on a ``CartesianMesh`` and the
results come back per case and rank.  A case's inputs are drawn from
seeds, so the caller can compute its reference from the same draws.  The
CPU tests (``tests/test_torch_parallel.py`` and its siblings) and the chip
check's distribution phase run these cases.
"""

import os
import pickle
import traceback
from datetime import timedelta
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.parallel import (
    LAST_EXCHANGE,
    CartesianMesh,
    DistributedField,
    FieldSharding,
    distribute,
    from_extended,
    gather,
    halo_exchange,
    overlapped_shard_map_stencil,
    shard_map_stencil,
    to_extended,
)
from gt4py_tpu_torch.parallel.distributed import _gather_blocks, _host

CASES: Dict[str, Any] = {}

#: MiniDycore's fields in the JAX tests' draw order, with their scales
DYCORE_FIELDS = (("u", 1.0), ("coeff", 0.025), ("wcon", 0.2), ("utens", 0.01),
                 ("utens_stage", 1.0))


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #


def _rank_main(rank: int, n: int, shape, device: str, workdir: str, cases, strict: bool,
               timeout: float) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    if device == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout))
    try:
        cmesh = CartesianMesh(tuple(shape), device=device, backend="gloo")
        results = {}
        for name, params in cases.items():
            fn = params.get("case", name)
            fn = CASES[fn] if isinstance(fn, str) else fn
            kw = {k: v for k, v in params.items() if k != "case"}
            if strict:
                results[name] = ("ok", fn(cmesh, **kw))
                continue
            try:
                results[name] = ("ok", fn(cmesh, **kw))
            except Exception:  # noqa: BLE001 -- reported as the case's failure
                results[name] = ("error", traceback.format_exc())
        with open(os.path.join(workdir, f"results.r{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def launch(cases: Dict[str, dict], *, workdir: str, ranks: int = 4, shape=(2, 2),
           device: str = "cpu", strict: bool = False, timeout: float = 120.0,
           limit: float = 900.0) -> Dict[str, List]:
    """Run ``cases`` (case name -> parameters; a ``"case"`` key runs that
    case function under another name, or a module-level function
    ``fn(cmesh, **parameters)`` of an importable module) on ``ranks`` gloo
    ranks laid out as
    ``shape``; returns case -> [(status, result) of each rank].  With
    ``strict`` a failing case fails its rank and the launch raises;
    otherwise a case's exception is its status ``"error"`` with the
    traceback.  ``timeout``: each rank's collectives' limit, seconds;
    ``limit``: the whole launch's, after which the ranks are terminated
    and ``TimeoutError`` raised."""
    import time

    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(ranks, tuple(shape), device, workdir, cases,
                                               strict, timeout),
                             nprocs=ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=5.0):  # raises where a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"dist_cases.launch: the ranks ran past {limit} s")
    per_rank = []
    for r in range(ranks):
        with open(os.path.join(workdir, f"results.r{r}.pkl"), "rb") as f:
            per_rank.append(pickle.load(f))
    return {name: [res[name] for res in per_rank] for name in cases}


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _torch_dtype(name):
    return None if name is None else getattr(torch, name)


def _r0(cmesh, value):
    """``value`` on rank 0, None elsewhere (results travel from rank 0)."""
    return value if cmesh.rank == 0 else None


def assemble(cmesh, block: torch.Tensor, spatial_axes=(0, 1)) -> np.ndarray:
    """Every rank's block side by side, x-major (the layout of the JAX
    package's ``to_extended`` arrays), on every rank."""
    coords = cmesh.coords()
    index = [(0, n) for n in block.shape]
    shape = list(block.shape)
    for m, a in enumerate(spatial_axes):
        index[a] = (coords[m] * block.shape[a], (coords[m] + 1) * block.shape[a])
        shape[a] *= cmesh.shape[m]
    return _gather_blocks(cmesh, _host(block), tuple(index), tuple(shape))


def dycore_state(shape, seed: int, dtype) -> Dict[str, np.ndarray]:
    """MiniDycore's global (K, I, J) fields, drawn as the JAX tests draw them."""
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.random(shape)).astype(dtype) for name, scale in DYCORE_FIELDS}


def fv_state(shape, seed: int, dtype) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    q = rng.random(shape)
    cx = 0.4 * (rng.random(shape) - 0.5)
    cy = 0.4 * (rng.random(shape) - 0.5)
    return {"q": q.astype(dtype), "cx": cx.astype(dtype), "cy": cy.astype(dtype)}


def _blocks(cmesh, state, spatial_axes=(1, 2)):
    sharding = FieldSharding(cmesh, spatial_axes)
    return {k: distribute(sharding, v).data for k, v in state.items()}


def _gathered(cmesh, blocks, names, spatial_axes=(1, 2)):
    return {n: assemble(cmesh, blocks[n], spatial_axes) for n in names}


# --------------------------------------------------------------------------- #
# halo exchange
# --------------------------------------------------------------------------- #


@case
def exchange(cmesh, *, shape, h, periodic=(True, True), boundary="zero", wire=None,
             dtype="float64", spatial_axes=(0, 1), seed=0):
    """Each rank's halo-extended block after one exchange of a global
    array drawn from ``seed``, assembled x-major; and ``LAST_EXCHANGE``."""
    arr = np.random.default_rng(seed).random(shape).astype(dtype)
    block = distribute(FieldSharding(cmesh, tuple(spatial_axes)), arr).data
    ext = halo_exchange(to_extended(cmesh, block, (h, h), spatial_axes), (h, h),
                        spatial_axes=spatial_axes, periodic=periodic, boundary=boundary,
                        wire_dtype=_torch_dtype(wire), cmesh=cmesh)
    out = assemble(cmesh, ext, spatial_axes)
    return {"ext": _r0(cmesh, out), "record": dict(LAST_EXCHANGE)}


# --------------------------------------------------------------------------- #
# the models' sharded steps
# --------------------------------------------------------------------------- #


def dycore_step(cmesh, nk, ni_l, nj_l, *, dtype, backend="cuda", mode="plain",
                periodic=(True, True), boundary="zero", wire=None):
    """A sharded MiniDycore step over this rank's (K, I, J) blocks:
    ``mode`` "plain" (``shard_map_stencil``), "overlap"
    (``overlapped_shard_map_stencil`` over ``region_step_factory``) or
    "extended" (``extended_state=True``: the blocks stay halo-extended)."""
    from gt4py_tpu_torch.models.dycore import MiniDycore

    local = MiniDycore(ni_l, nj_l, nk, dtype=np.dtype(dtype), backend=backend, aligned=False,
                       device=cmesh.device)
    h = MiniDycore.HALO
    names = tuple(n for n, _ in DYCORE_FIELDS)
    kw = dict(field_names=names, spatial_axes=(1, 2), periodic=periodic, boundary=boundary,
              halo_wire_dtype=_torch_dtype(wire))
    if mode == "overlap":
        return local, overlapped_shard_map_stencil(local.region_step_factory(), cmesh, (h, h),
                                                   local_shape=(ni_l, nj_l), **kw)
    lstep = local.step_fn(fill_halos=False)
    return local, shard_map_stencil(lambda **f: lstep(dict(f)), cmesh, (h, h),
                                    extended_state=mode == "extended", **kw)


@case
def dycore(cmesh, *, shape, dtype="float64", seed=0, steps=1, mode="plain",
           periodic=(True, True), boundary="zero", wire=None, compare_single=False):
    """``steps`` sharded MiniDycore steps of the global state drawn from
    ``seed``: the gathered ``u`` and ``utens_stage``.  ``compare_single``:
    rank 0 also runs them on a mesh of its own over the whole domain."""
    nk, ni, nj = shape
    px, py = cmesh.shape
    state = dycore_state(shape, seed, dtype)
    h = 3

    def run(mesh, ni_l, nj_l, blocks):
        _, step = dycore_step(mesh, nk, ni_l, nj_l, dtype=dtype, mode=mode, periodic=periodic,
                              boundary=boundary, wire=wire)
        if mode == "extended":
            blocks = {k: to_extended(mesh, v, (h, h), (1, 2)) for k, v in blocks.items()}
        for _ in range(steps):
            blocks = step(**blocks)
        if mode == "extended":
            blocks = {k: from_extended(mesh, v, (h, h), (1, 2)) for k, v in blocks.items()}
        return blocks

    out = run(cmesh, ni // px, nj // py, _blocks(cmesh, state))
    result = _gathered(cmesh, out, ("u", "utens_stage"))
    if compare_single and cmesh.rank == 0:
        single = CartesianMesh.single(cmesh.device)
        whole = run(single, ni, nj, {k: torch.from_numpy(v).to(cmesh.device)
                                     for k, v in state.items()})
        result["single"] = {n: _host(whole[n]) for n in ("u", "utens_stage")}
    return _r0(cmesh, result)


@case
def fv(cmesh, *, shape, dtype="float64", seed=7):
    """One sharded FvAdvection step (``local_step_fn``, halo
    ``FvAdvection.HALO``): the gathered ``q``."""
    from gt4py_tpu_torch.models.fv_advection import FvAdvection

    nk, ni, nj = shape
    local = FvAdvection(ni // cmesh.px, nj // cmesh.py, nk, dtype=np.dtype(dtype), aligned=False,
                        device=cmesh.device)
    lstep = local.local_step_fn()
    h = FvAdvection.HALO
    step = shard_map_stencil(lambda **kw: {"q": lstep(kw["q"], kw["cx"], kw["cy"])}, cmesh,
                             (h, h), field_names=("q", "cx", "cy"), spatial_axes=(1, 2))
    out = step(**_blocks(cmesh, fv_state(shape, seed, dtype)))
    return _r0(cmesh, _gathered(cmesh, out, ("q",)))


@case
def shallow_water(cmesh, *, shape, dtype="float64", seed=5):
    """One sharded ShallowWater step from the single-device model's
    initial state: the gathered ``h``, ``u``, ``v``."""
    from gt4py_tpu_torch.models.shallow_water import ShallowWater

    nk, ni, nj = shape
    h = ShallowWater.HALO
    dtype = np.dtype(dtype)
    single = ShallowWater(ni, nj, nk, dtype=dtype, aligned=False, device="cpu")
    state = {k: v[:, h: h + ni, h: h + nj].numpy() for k, v in single.init_state(seed).items()}
    local = ShallowWater(ni // cmesh.px, nj // cmesh.py, nk, dtype=dtype, aligned=False,
                         device=cmesh.device)
    lstep = local.local_step_fn()

    def fields_step(**kw):
        return dict(zip(("h", "u", "v"), lstep(kw["h"], kw["u"], kw["v"])))

    step = shard_map_stencil(fields_step, cmesh, (h, h), field_names=("h", "u", "v"),
                             spatial_axes=(1, 2))
    out = step(**_blocks(cmesh, state))
    return _r0(cmesh, _gathered(cmesh, out, ("h", "u", "v")))


# --------------------------------------------------------------------------- #
# stencils on the mesh: explicit and global view
# --------------------------------------------------------------------------- #


Field64 = gtscript.Field[np.float64]


def _lap_stencil(backend):
    @gtscript.stencil(backend=backend)
    def lap(out_f: Field64, in_f: Field64):
        with computation(PARALLEL), interval(...):
            out_f = -4.0 * in_f[0, 0, 0] + (
                in_f[1, 0, 0] + in_f[-1, 0, 0] + in_f[0, 1, 0] + in_f[0, -1, 0])

    return lap


def _cumsum_stencil(backend):
    @gtscript.stencil(backend=backend)
    def cumsum(inp: Field64, out: Field64):
        with computation(FORWARD):
            with interval(0, 1):
                out = inp
            with interval(1, None):
                out = out[0, 0, -1] + inp

    return cumsum


@case
def global_laplacian(cmesh, *, shape=(32, 32, 4), seed=0, backend="cuda"):
    """The Laplacian's ``functional`` on ``DistributedField``s (origin
    (1, 1, 0), the domain inside a one-point halo): the gathered result."""
    NI, NJ, NK = shape
    inp = np.random.default_rng(seed).random(shape)
    fn = _lap_stencil(backend).functional(origin=(1, 1, 0), domain=(NI - 2, NJ - 2, NK))
    out = fn(out_f=distribute(cmesh, np.zeros(shape)), in_f=distribute(cmesh, inp))["out_f"]
    return _r0(cmesh, gather(out))


@case
def shard_map_laplacian(cmesh, *, shape=(16, 32, 4), seed=1, backend="cuda"):
    """The periodic Laplacian as a local step under ``shard_map_stencil``."""
    NI, NJ, NK = shape
    ni, nj = NI // cmesh.px, NJ // cmesh.py
    local_fn = _lap_stencil(backend).functional(origin=(1, 1, 0), domain=(ni, nj, NK))
    step = shard_map_stencil(lambda out_f, in_f: local_fn(out_f=out_f, in_f=in_f), cmesh,
                             (1, 1), field_names=("out_f", "in_f"))
    inp = np.random.default_rng(seed).random(shape)
    out = step(out_f=distribute(cmesh, np.zeros(shape)).data,
               in_f=distribute(cmesh, inp).data)["out_f"]
    return _r0(cmesh, assemble(cmesh, out))


@case
def serial_k(cmesh, *, shape=(8, 16, 9), seed=2, backend="cuda"):
    """A FORWARD cumulative sum under ``shard_map_stencil`` with no halo."""
    NI, NJ, NK = shape
    ni, nj = NI // cmesh.px, NJ // cmesh.py
    local_fn = _cumsum_stencil(backend).functional(origin=(0, 0, 0), domain=(ni, nj, NK))
    step = shard_map_stencil(lambda inp, out: local_fn(inp=inp, out=out), cmesh, (0, 0),
                             field_names=("inp", "out"))
    inp = np.random.default_rng(seed).random(shape)
    out = step(inp=distribute(cmesh, inp).data,
               out=distribute(cmesh, np.zeros(shape)).data)["out"]
    return _r0(cmesh, assemble(cmesh, out))


def gspmd_program(seed: int):
    """The JAX package's GSPMD fuzz leg's draws for ``seed``: (generator,
    stencil, domain, arrays, scalars), the arrays' buffers with a halo of 6
    and origin (6, 6, 1)."""
    import random

    from gt4py_tpu_torch.testing.program_gen import ProgramGenerator

    rng = random.Random(seed)
    domain = (2 * rng.randint(2, 8), 4 * rng.randint(2, 6), rng.randint(1, 7))
    gen = ProgramGenerator(rng, dtype=np.float64)
    stencil = gen.generate()
    h = 6
    shape = (domain[0] + 2 * h, domain[1] + 2 * h, domain[2] + 2)
    nprng = np.random.default_rng(seed)
    arrays = {n: nprng.random(shape) for n in gen.inputs + gen.outputs}
    scalars = {"s0": nprng.uniform(-1, 1), "s1": nprng.uniform(-1, 1)}
    return gen, stencil, domain, arrays, scalars


def gspmd_stencil(seed: int, backend: str):
    """``gspmd_program(seed)``'s stencil object on ``backend``, and the
    program's draws."""
    from gt4py_tpu_torch.cartesian import analysis as analysis_mod
    from gt4py_tpu_torch.cartesian.backend import from_name
    from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

    _, stencil, domain, arrays, scalars = gspmd_program(seed)
    an = analysis_mod.analyze(stencil)
    obj = StencilObject(analysis=an, backend=from_name(backend)(an, {}), backend_name=backend,
                        name=stencil.name, options={}, stencil_id=f"gspmd-{seed}")
    return obj, domain, arrays, scalars


def run_gspmd(cmesh, obj, domain, arrays, scalars) -> Dict[str, np.ndarray]:
    """The program run in place on ``DistributedField``s: every field
    gathered after the call."""
    fields = {n: distribute(cmesh, a) for n, a in arrays.items()}
    obj.run(_domain_=domain, _origin_={n: (6, 6, 1) for n in fields}, **fields, **scalars)
    return {n: gather(f) for n, f in fields.items()}


@case
def gspmd(cmesh, *, seed, backend="torch"):
    """A generated program (``gspmd_program``) run in place on
    ``DistributedField``s: every field gathered after the call, and under
    ``"record"`` what the call ran (``parallel.distributed.LAST_GLOBAL``)."""
    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL

    fields = run_gspmd(cmesh, *gspmd_stencil(seed, backend))
    return _r0(cmesh, {**fields, "record": dict(LAST_GLOBAL)})


def gspmd_single(seed: int, backend: str = "torch", device="cpu") -> Dict[str, np.ndarray]:
    """``gspmd_program(seed)``'s single-device run on ``backend``: every
    field after the call."""
    obj, domain, arrays, scalars = gspmd_stencil(seed, backend)
    tensors = {n: torch.from_numpy(a.copy()).to(device) for n, a in arrays.items()}
    obj.run(_domain_=domain, _origin_={n: (6, 6, 1) for n in tensors}, **tensors, **scalars)
    return {n: _host(t) for n, t in tensors.items()}


@case
def gspmd_or_decline(cmesh, *, seed, backend="torch"):
    """``gspmd``, or ``("declined", message)`` where the call on
    ``DistributedField``s raises ``NotImplementedError``."""
    try:
        return gspmd(cmesh, seed=seed, backend=backend)
    except NotImplementedError as e:
        return ("declined", str(e))


@case
def gspmd_undeclined(cmesh, *, seed, backend="torch"):
    """``gspmd`` with ``cross_rank_read``'s decline switched off: what the
    ranks compute from one exchange where the stencil needs more."""
    from gt4py_tpu_torch.parallel import distributed

    check = distributed.cross_rank_read
    distributed.cross_rank_read = lambda analysis: None
    try:
        return gspmd(cmesh, seed=seed, backend=backend)
    finally:
        distributed.cross_rank_read = check


def _ring_stencil(backend):
    # an earlier level read at the neighbour's point, before the writer of
    # the level, which the extent analysis leaves at the domain's own points
    @gtscript.stencil(backend=backend)
    def ring(a: Field64, c: Field64):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t
            with interval(1, None):
                c = t[1, 0, -1]
                t = a * 2.0

    return ring


@case
def ring(cmesh, *, shape=(24, 36, 5), seed=0, backend="cuda", emulate=None):
    """The ring read's stencil on ``DistributedField``s, which runs one
    level at a time: the gathered ``c``, what the call ran
    (``LAST_GLOBAL``), and each phase stencil's calls that launched its
    kernels (``"cuda"``).  ``emulate``: a context manager factory that the
    call runs under (the CPU tests' emulated kernels)."""
    import contextlib

    from gt4py_tpu_torch.cartesian.backend.cuda_backend import library_launches
    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL, _plan_of

    rng = np.random.default_rng(seed)
    a, c = rng.random(shape), np.zeros(shape)
    st = _ring_stencil(backend)
    fn = st.functional(origin=(1, 1, 0), domain=(shape[0] - 4, shape[1] - 2, shape[2]))
    with emulate() if emulate is not None else contextlib.nullcontext():
        before = library_launches()
        out = fn(a=distribute(cmesh, a), c=distribute(cmesh, c))["c"]
        counted = library_launches() - before
    return _r0(cmesh, {"c": gather(out), "record": dict(LAST_GLOBAL),
                       "library_launches": counted,
                       "phase_launches": [getattr(o.backend, "launches", 0)
                                          for o in _plan_of(st).onces]})


def ring_single(shape=(24, 36, 5), seed=0, backend="torch", device="cpu") -> np.ndarray:
    """``ring``'s ``c`` from the single-device call."""
    rng = np.random.default_rng(seed)
    a, c = rng.random(shape), np.zeros(shape)
    fn = _ring_stencil(backend).functional(origin=(1, 1, 0),
                                           domain=(shape[0] - 4, shape[1] - 2, shape[2]))
    out = fn(a=torch.from_numpy(a).to(device), c=torch.from_numpy(c).to(device))["c"]
    return _host(out)


# --------------------------------------------------------------------------- #
# the next DSL
# --------------------------------------------------------------------------- #


def next_ops():
    """The field-view operators of the next cases (built once)."""
    if "ops" in _NEXT:
        return _NEXT["ops"]
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dims, Field

    I = gtx.Dimension("I")  # noqa: E741
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    F2 = Field[Dims[I, J], gtx.float64]

    @gtx.field_operator
    def lap(f: F2) -> F2:
        return f(Ioff[1]) + f(Ioff[-1]) + f(Joff[1]) + f(Joff[-1]) - 4.0 * f

    @gtx.field_operator
    def wide(f: F2, g: F2) -> F2:
        return f(Ioff[2]) + f(Ioff[-1]) + g(Joff[1]) + g(Joff[-2]) - 4.0 * f

    @gtx.field_operator
    def gradx(f: F2) -> F2:
        return f(Ioff[1]) - f

    @gtx.field_operator
    def two(f: F2, w: gtx.float64) -> tuple[F2, F2]:
        g = f(Ioff[1]) - f
        return w * g, g * g

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def acc(carry: float, x: float) -> float:
        return carry + x

    _NEXT["ops"] = dict(gtx=gtx, I=I, J=J, K=K, lap=lap, wide=wide, gradx=gradx, two=two,
                        acc=acc)
    return _NEXT["ops"]


_NEXT: Dict[str, Any] = {}


def _f2(seed, shape=(16, 32)):
    return np.random.default_rng(seed).random(shape)


@case
def next_distribute(cmesh, *, seed=0):
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    data = _f2(seed)
    f = o["gtx"].as_field((o["I"], o["J"]), data, device=cmesh.device)
    fd = nxd.distribute(f, cmesh)
    sh = nxd.sharding_of(fd)
    back = nxd.gather(fd)
    return {"same_domain": fd.domain == f.domain, "block": tuple(fd.data.shape),
            "replicated": sh.is_fully_replicated,
            "dim_map": {d.value: ax for d, ax in sh.dim_map.items()},
            "gathered": _r0(cmesh, back.asnumpy()), "ranges": [
                (r.start, r.stop) for r in back.domain.ranges]}


@case
def next_lap(cmesh, *, seed=1):
    """``lap`` called on sharded fields: the global result's domain (shrunk
    at the global edges by the shifts) and values."""
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    f = nxd.distribute(o["gtx"].as_field((o["I"], o["J"]), _f2(seed), device=cmesh.device),
                       cmesh, {o["I"]: "x", o["J"]: "y"})
    out = o["lap"](f)
    g = nxd.gather(out)
    return {"ranges": [(r.start, r.stop) for r in g.domain.ranges],
            "values": _r0(cmesh, g.asnumpy()),
            "replicated": nxd.sharding_of(out).is_fully_replicated}


@case
def next_scan(cmesh, *, seed=3):
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    data = np.random.default_rng(seed).random((8, 16, 5))
    f = nxd.distribute(o["gtx"].as_field((o["I"], o["J"], o["K"]), data, device=cmesh.device),
                       cmesh, {o["I"]: "x", o["J"]: "y"})
    return _r0(cmesh, nxd.gather(o["acc"](f)).asnumpy())


@case
def next_refusals(cmesh):
    """The ``ValueError`` of each placement ``field_sharding`` refuses."""
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    gtx, I, J, K = o["gtx"], o["I"], o["J"], o["K"]
    out = {}
    for key, field, dim_map in (
            ("vertical", gtx.as_field((K,), np.arange(8.0), device=cmesh.device), {K: "x"}),
            ("uneven", gtx.as_field((I, J), np.zeros((15, 32)), device=cmesh.device),
             {I: "x", J: "y"}),
            ("unknown_axis", gtx.as_field((I, J), np.zeros((16, 32)), device=cmesh.device),
             {I: "z"})):
        try:
            nxd.distribute(field, cmesh, dim_map)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


@case
def next_replicate(cmesh):
    """A replicated connectivity and field: placement and a neighbour sum
    of the replicated values on every rank."""
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    gtx = o["gtx"]
    Vertex = gtx.Dimension("Vertex")
    V2VDim = gtx.Dimension("V2V", kind=gtx.DimensionKind.LOCAL)
    nv = 16
    table = np.stack([(np.arange(nv) + 1) % nv, (np.arange(nv) - 1) % nv], axis=1)
    conn = nxd.replicate(gtx.as_connectivity(table, source=Vertex, codomain=Vertex,
                                             local_dim=V2VDim, device="cpu"), cmesh)
    mask = nxd.replicate(gtx.as_field((Vertex,), np.ones(nv), device="cpu"), cmesh)
    vals = np.random.default_rng(4).random(nv)
    vf = nxd.replicate(gtx.as_field((Vertex,), vals, device="cpu"), cmesh)
    out = gtx.neighbor_sum(vf(conn), axis=V2VDim)
    return {"conn": nxd.sharding_of(conn).is_fully_replicated,
            "mask": nxd.sharding_of(mask).is_fully_replicated,
            "device": str(conn.table.device), "sum": out.asnumpy()}


@case
def next_shard_map(cmesh, *, op, periodic=True, seed=11, w=None):
    """``shard_map_operator`` of one of ``next_ops``' operators on the
    sharded fields drawn from ``seed``: the gathered output(s)."""
    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    rng = np.random.default_rng(seed)
    a, b = rng.random((16, 32)), rng.random((16, 32))
    dmap = {o["I"]: "x", o["J"]: "y"}
    fa = nxd.distribute(o["gtx"].as_field((o["I"], o["J"]), a, device=cmesh.device), cmesh, dmap)
    fb = nxd.distribute(o["gtx"].as_field((o["I"], o["J"]), b, device=cmesh.device), cmesh, dmap)
    step = nxd.shard_map_operator(o[op], cmesh, dmap, periodic=periodic)
    if op == "wide":
        out = step(fa, fb)
    elif op == "two":
        out = step(fa, w=w)
    else:
        out = step(fa)
    outs = out if isinstance(out, tuple) else (out,)
    return _r0(cmesh, [nxd.gather(x).asnumpy() for x in outs])


# --------------------------------------------------------------------------- #
# checkpoints and resilience
# --------------------------------------------------------------------------- #


def checkpoint_state(cmesh, seed: int = 21):
    """A state of distributed fields (float64, bfloat16 from float32
    values, a sharded next field) and replicated arrays, from ``seed``."""
    from gt4py_tpu_torch.next import distributed as nxd

    rng = np.random.default_rng(seed)
    u = rng.random((8, 12, 3))
    b = rng.random((3, 8, 12)).astype(np.float32)
    t = rng.random((5,))
    o = next_ops()
    nf = nxd.distribute(o["gtx"].as_field((o["I"], o["J"]), rng.random((8, 12)),
                                          device=cmesh.device), cmesh)
    return {
        "u": distribute(cmesh, u),
        "b": distribute(FieldSharding(cmesh, (1, 2)),
                        dtypes.cast(torch.from_numpy(b), torch.bfloat16)),
        "nf": nf,
        "t": t,
        "bt": dtypes.cast(torch.from_numpy(b[0, 0]), torch.bfloat16),
    }


def _whole(value):
    """A loaded or gathered value as numpy (bfloat16 widened to float32)."""
    if isinstance(value, DistributedField):
        return gather(value)
    if isinstance(value, torch.Tensor):
        return _host(value)
    return np.asarray(value)


@case
def ckpt_save(cmesh, *, directory, wait=True):
    """Save ``checkpoint_state`` sharded; ``wait=False`` through the async
    handle.  Returns whether the directory is complete after a barrier."""
    from gt4py_tpu_torch.utils.checkpoint import is_checkpoint_complete, save_checkpoint_sharded

    got = save_checkpoint_sharded(directory, checkpoint_state(cmesh), step=7,
                                  metadata={"note": "port"}, wait=wait)
    if not wait:
        got = got.wait()
    dist.barrier()
    return {"returned": got, "complete": is_checkpoint_complete(directory)}


@case
def ckpt_load(cmesh, *, directory, reshard=None):
    """Load a checkpoint, ``u`` re-sharded onto this mesh (or onto a new
    mesh of shape ``reshard``); every array gathered whole."""
    from gt4py_tpu_torch.utils.checkpoint import load_checkpoint_sharded

    mesh = cmesh if reshard is None else CartesianMesh(tuple(reshard), device=cmesh.device,
                                                       backend="gloo")
    state, meta = load_checkpoint_sharded(directory, shardings={"u": mesh})
    out = {k: _whole(v) for k, v in state.items()}
    out["__types__"] = {k: type(v).__name__ for k, v in state.items()}
    out["__dtypes__"] = {k: str(getattr(v, "dtype", None)) for k, v in state.items()}
    out["__u_block__"] = tuple(state["u"].data.shape)
    return {"state": _r0(cmesh, out), "meta": meta}


@case
def resilient(cmesh, *, directory, fail_at=3):
    """``run_resilient`` over a sharded Laplacian-smoothing step that fails
    once with a transient error at step ``fail_at``: the rolled-back run's
    gathered state and report, a clean run's, and a fresh call's resume."""
    from gt4py_tpu_torch.utils.resilience import run_resilient

    lap = _lap_stencil("cuda").functional(origin=(1, 1, 0), domain=(14, 14, 2))
    failed = {"done": False}

    def step(state, fail=True):
        if fail and not failed["done"] and state["n"] == fail_at:
            failed["done"] = True
            raise dist.DistNetworkError("injected: connection reset")
        out = lap(out_f=state["a"], in_f=state["a"])["out_f"]
        return {"a": out, "n": state["n"] + 1}

    a0 = np.random.default_rng(3).random((16, 16, 2))

    def init():
        return {"a": distribute(cmesh, a0), "n": 0}

    run_a, rep_a = run_resilient(lambda s: step(s), init(), n_steps=5, directory=directory,
                                 checkpoint_every=2)
    clean, _ = run_resilient(lambda s: step(s, fail=False), init(), n_steps=5,
                             directory=directory + "_clean", checkpoint_every=0)
    dist.barrier()
    resumed, rep_r = run_resilient(lambda s: step(s, fail=False), None, n_steps=7,
                                   directory=directory, checkpoint_every=2,
                                   shardings={"a": cmesh})
    return {"a": _r0(cmesh, gather(run_a["a"])), "clean": _r0(cmesh, gather(clean["a"])),
            "resumed": _r0(cmesh, gather(resumed["a"])),
            "report": (rep_a.steps_run, rep_a.restarts, rep_a.checkpoints, len(rep_a.failures)),
            "resumed_from": rep_r.resumed_from, "resumed_steps": rep_r.steps_run,
            "n": int(np.asarray(resumed["n"]))}


# --------------------------------------------------------------------------- #
# the chip check's distribution phase
# --------------------------------------------------------------------------- #


def _median_ms(fn, reps: int, device) -> float:
    """Median over ``reps`` calls of ``fn``'s time on the rank's CUDA stream
    (CUDA events), after one warm-up call (on the CPU: wall-clock)."""
    import statistics

    if device.type != "cuda":
        return _median_host_ms(fn, reps, device)
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize(device)
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _median_host_ms(fn, reps: int, device) -> float:
    """Median wall-clock time of ``fn`` to completion on the card."""
    import statistics
    import time

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(stencils) -> Dict[str, int]:
    return {name: st.backend.device_launches()["all"] for name, st in stencils.items()}


def _embedded(arr: np.ndarray, h: int, device) -> torch.Tensor:
    """A (K, I, J) interior inside a zero halo of ``h``, on ``device``."""
    nk, ni, nj = arr.shape
    buf = torch.zeros((nk, ni + 2 * h, nj + 2 * h), dtype=dtypes.to_torch(arr.dtype),
                      device=device)
    buf[:, h:h + ni, h:h + nj] = torch.from_numpy(arr).to(device)
    return buf


def _max_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


#: the JAX package's GSPMD fuzz leg's seeds (regions, ``while``, variable K)
GSPMD_SEEDS = tuple(range(11000, 11006))


@case
def chip_distribution(cmesh, *, shape=(80, 512, 512), steps=3, reps=10, seed=0,
                      gspmd_seeds=GSPMD_SEEDS):
    """The chip check's phase 15 on every rank of a 2x2 mesh on the card
    (see ``chip_smoke.py``): the sharded MiniDycore step (``steps`` steps)
    with each rank's kernel launches read from the libraries around its
    run, the overlapped step, the sharded FvAdvection step and a bfloat16
    wire, each held by rank 0 to a single-device run on the card; then each
    rank's times.  float32.  Then the global view: each of ``gspmd_seeds``'
    programs (float64) on ``"cuda"`` on DistributedFields, its kernels'
    launches read from its library around each rank's call, held by rank 0
    to the plain executor's single-device run on the card."""
    from gt4py_tpu_torch.models.dycore import MiniDycore
    from gt4py_tpu_torch.models.fv_advection import FvAdvection
    from gt4py_tpu_torch.parallel.halo import HaloExchange, _pad
    from gt4py_tpu_torch.parallel import halo_comm_bytes

    dev = cmesh.device
    nk, ni, nj = shape
    ni_l, nj_l = ni // cmesh.px, nj // cmesh.py
    dt = np.dtype(np.float32)
    h = MiniDycore.HALO
    names = tuple(n for n, _ in DYCORE_FIELDS)
    state = dycore_state(shape, seed, dt)
    blocks0 = _blocks(cmesh, state)
    local, step = dycore_step(cmesh, nk, ni_l, nj_l, dtype=dt)
    _, over = dycore_step(cmesh, nk, ni_l, nj_l, dtype=dt, mode="overlap")
    stencils = {"hdiff": local.hdiff, "vadv_update": local.vadv_upd}
    out: Dict[str, Any] = {"rank": cmesh.rank, "device": str(dev),
                           "backend": cmesh.backend, "block": [nk, ni_l, nj_l]}

    def run(fn, n):
        b = blocks0
        for _ in range(n):
            b = fn(**b)
        return b

    # 1. the sharded step, its launches counted by the stencils' libraries
    before = _launches(stencils)
    plain = run(step, steps)
    _sync(dev)
    out["launches"] = {k: v - before[k] for k, v in _launches(stencils).items()}
    out["exchange"] = dict(LAST_EXCHANGE)
    # 2. the overlapped step
    before = _launches(stencils)
    overlapped = run(over, steps)
    _sync(dev)
    out["overlap_launches"] = {k: v - before[k] for k, v in _launches(stencils).items()}
    out["overlap_vs_plain"] = max(float((overlapped[n] - plain[n]).abs().max())
                                  for n in ("u", "utens_stage"))
    got = _gathered(cmesh, plain, ("u", "utens_stage"))
    # 3. FvAdvection
    fv_local = FvAdvection(ni_l, nj_l, nk, dtype=dt, aligned=False, device=dev)
    fv_lstep = fv_local.local_step_fn()
    fh = FvAdvection.HALO
    fv_step = shard_map_stencil(lambda **kw: {"q": fv_lstep(kw["q"], kw["cx"], kw["cy"])},
                                cmesh, (fh, fh), field_names=("q", "cx", "cy"),
                                spatial_axes=(1, 2))
    fstate = fv_state(shape, seed + 1, dt)
    fblocks = _blocks(cmesh, fstate)
    before = fv_local.fv_step.backend.device_launches()["all"]
    fq = fv_step(**fblocks)["q"]
    _sync(dev)
    out["fv_launches"] = fv_local.fv_step.backend.device_launches()["all"] - before
    fv_got = assemble(cmesh, fq, (1, 2))
    # 4. a bfloat16 wire: each rank's exchanged blocks are the float32
    # exchange's, every received strip cast to bfloat16 and back
    _, wstep = dycore_step(cmesh, nk, ni_l, nj_l, dtype=dt, wire="bfloat16")
    wired = _gathered(cmesh, wstep(**blocks0), ("u",))["u"]
    exact = [_pad(blocks0[n], (h, h), (1, 2)) for n in names]
    wire = [p.clone() for p in exact]
    HaloExchange(exact, (h, h), cmesh, spatial_axes=(1, 2)).run()
    HaloExchange(wire, (h, h), cmesh, spatial_axes=(1, 2), wire_dtype=torch.bfloat16).run()
    out["wire_exchange"] = dict(LAST_EXCHANGE)
    strip = torch.ones(exact[0].shape[1:], dtype=torch.bool, device=dev)
    strip[h:-h, h:-h] = False
    cast = [torch.where(strip, dtypes.cast(dtypes.cast(e, torch.bfloat16), e.dtype), e)
            for e in exact]
    out["wire_blocks_equal"] = all(torch.equal(w, c) for w, c in zip(wire, cast))
    out["wire_blocks_max_abs"] = max(float((w - c).abs().max()) for w, c in zip(wire, cast))
    out["wire_strips_moved"] = max(float((w - e).abs().max()) for w, e in zip(wire, exact))
    ext = (nk, ni_l + 2 * h, nj_l + 2 * h)
    out["wire_bytes"] = {
        "float32": halo_comm_bytes(ext, (h, h), dt, (1, 2), n_fields=len(names)),
        "bfloat16": halo_comm_bytes(ext, (h, h), dt, (1, 2), wire_dtype=torch.bfloat16,
                                    n_fields=len(names))}
    one = _gathered(cmesh, step(**blocks0), ("u",))["u"]
    # 5. times: the step, the exchange, each kernel
    out["step_ms"] = _median_ms(lambda: step(**blocks0), reps, dev)
    out["overlap_step_ms"] = _median_ms(lambda: over(**blocks0), reps, dev)
    pads = [_pad(blocks0[n], (h, h), (1, 2)) for n in names]
    out["exchange_ms"] = _median_host_ms(
        lambda: HaloExchange(pads, (h, h), cmesh, spatial_axes=(1, 2)).run(), reps, dev)
    out["wire_exchange_ms"] = _median_host_ms(
        lambda: HaloExchange(pads, (h, h), cmesh, spatial_axes=(1, 2),
                             wire_dtype=torch.bfloat16).run(), reps, dev)
    ex = {n: p for n, p in zip(names, pads)}
    fpads = [_pad(fblocks[n], (fh, fh), (1, 2)) for n in ("q", "cx", "cy")]
    diffused = local.hdiff_fn(in_field=ex["u"], out_field=ex["u"],
                              coeff=ex["coeff"])["out_field"]
    out["kernel_ms"] = {
        "hdiff": _median_ms(lambda: local.hdiff_fn(in_field=ex["u"], out_field=ex["u"],
                                                   coeff=ex["coeff"]), reps, dev),
        "vadv_update": _median_ms(lambda: local.vadv_upd_fn(
            utens_stage=ex["utens_stage"], u_stage=diffused, wcon=ex["wcon"], u_pos=diffused,
            utens=ex["utens"], u_out=ex["u"], dtr_stage=3.0), reps, dev),
        "fv_step": _median_ms(lambda: fv_lstep(*fpads), reps, dev),
    }
    out["fv_sharded_step_ms"] = _median_ms(lambda: fv_step(**fblocks), reps, dev)
    # 6. the global view on the kernels: regions in the global frame
    views = {}
    for sd in gspmd_seeds:
        obj, domain, arrays, scalars = gspmd_stencil(sd, "cuda")
        if dev.type == "cuda":  # the library's count starts at its load
            obj.backend.build()
        before = obj.backend.device_launches()["all"]
        views[sd] = run_gspmd(cmesh, obj, domain, arrays, scalars)
        _sync(dev)
        out.setdefault("gspmd_launches", {})[sd] = obj.backend.device_launches()["all"] - before
    ranks = [None] * cmesh.size
    dist.all_gather_object(ranks, out)
    if cmesh.rank != 0:
        return out
    gspmd_err = {}
    for sd in gspmd_seeds:
        single = gspmd_single(sd, "torch", dev)
        gspmd_err[sd] = max(_max_err(views[sd][n], a) for n, a in single.items())
    # rank 0: the single-device references on the card
    single = MiniDycore(ni, nj, nk, dtype=dt, aligned=False, device=dev)
    s = {k: _embedded(v, h, dev) for k, v in state.items()}
    one_step = single.step_fn()
    s1 = one_step(s)
    u1 = s1["u"][:, h:h + ni, h:h + nj].cpu().numpy()
    for _ in range(steps - 1):
        s1 = one_step(s1)
    ref = {n: s1[n][:, h:h + ni, h:h + nj].cpu().numpy() for n in ("u", "utens_stage")}
    fv_single = FvAdvection(ni, nj, nk, dtype=dt, aligned=False, device=dev)
    fe = {k: _embedded(v, fh, dev) for k, v in fstate.items()}
    fv_ref = fv_single.step_fn()(fe["q"], fe["cx"], fe["cy"])[:, fh:fh + ni, fh:fh + nj]
    fv_ref = fv_ref.cpu().numpy()
    q0 = float(fstate["q"].sum(dtype=np.float64))
    return {
        "ranks": ranks,
        "max_abs_err": {n: _max_err(got[n], ref[n]) for n in ("u", "utens_stage")},
        "equal": {n: bool(np.array_equal(got[n], ref[n])) for n in ("u", "utens_stage")},
        "close": {n: bool(np.allclose(got[n], ref[n], rtol=1e-6, atol=1e-7))
                  for n in ("u", "utens_stage")},
        "fv_close": bool(np.allclose(fv_got, fv_ref, rtol=1e-6, atol=1e-7)),
        "fv_max_abs_err": _max_err(fv_got, fv_ref),
        "fv_equal": bool(np.array_equal(fv_got, fv_ref)),
        "fv_mass_rel": abs(float(fv_got.sum(dtype=np.float64)) - q0) / abs(q0),
        "wire_max_abs_vs_float32": _max_err(wired, one),
        "one_step_vs_single": _max_err(one, u1),
        "gspmd_max_abs_err": gspmd_err,
        "finite": bool(np.isfinite(got["u"]).all() and np.isfinite(fv_got).all()),
    }


#: the phased calls of the chip check's phase 15: the ring (I, J, K) and
#: the generated programs that read a neighbour's writes of the call
PHASED_RING_SHAPE = (512, 512, 80)
PHASED_SEEDS = (11203, 11238)


@case
def chip_phased(cmesh, *, ring_shape=PHASED_RING_SHAPE, seeds=PHASED_SEEDS, reps=5):
    """The chip check's phased calls on every rank (see ``chip_smoke.py``,
    phase 15): the ring stencil (float64, one level at a time) and the
    programs ``seeds`` (a ``while`` iterated across the ranks, a serial
    loop a level at a time) on ``"cuda"`` on DistributedFields, each
    rank's kernel launches read from the stencil libraries around its
    call, what the call ran (``LAST_GLOBAL``, its phases' kernel time
    from the last timed call), its time (CUDA events, median of ``reps``);
    rank 0 holds each to the single-device ``"cuda"`` run on the card, bit
    for bit, and times that too."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, library_launches
    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL, _plan_of

    dev = cmesh.device
    out: Dict[str, Any] = {"rank": cmesh.rank}
    got: Dict[str, Dict[str, np.ndarray]] = {}
    rng = np.random.default_rng(0)
    a, c = rng.random(ring_shape), np.zeros(ring_shape)
    ring_st = _ring_stencil("cuda")
    ring_fn = ring_st.functional(origin=(1, 1, 0),
                                 domain=(ring_shape[0] - 4, ring_shape[1] - 2, ring_shape[2]))
    ring_args = {"a": distribute(cmesh, a), "c": distribute(cmesh, c)}
    calls = {"ring": (ring_st, lambda: ring_fn(**ring_args))}
    for sd in seeds:
        obj, domain, arrays, scalars = gspmd_stencil(sd, "cuda")
        fields = {n: distribute(cmesh, v) for n, v in arrays.items()}

        def call(obj=obj, domain=domain, fields=fields, scalars=scalars):
            obj.run(_domain_=domain, _origin_={n: (6, 6, 1) for n in fields}, **fields,
                    **scalars)
            return fields

        calls[f"gspmd_{sd}"] = (obj, call)
    for name, (st, call) in calls.items():
        before = library_launches()
        res = call()
        _sync(dev)
        rec = dict(LAST_GLOBAL)
        rec["library_launches"] = library_launches() - before
        rec["phase_launches"] = [o.backend.launches for o in _plan_of(st).onces]
        rec["forms"] = {o.analysis.stencil.name: LAST_PLAN[o.analysis.stencil.name]["forms"]
                        for o in _plan_of(st).onces}
        got[name] = {"c": gather(res["c"])} if name == "ring" else \
            {n: gather(f) for n, f in res.items()}
        rec["ms"] = _median_ms(call, reps, dev)
        rec["kernel_ms"] = LAST_GLOBAL.get("kernel_ms")  # the last timed call's
        out[name] = rec
    ranks = [None] * cmesh.size
    dist.all_gather_object(ranks, out)
    if cmesh.rank != 0:
        return out
    single: Dict[str, Any] = {}
    for name, (st, call) in calls.items():
        if name == "ring":
            ref = {"c": ring_single(ring_shape, backend="cuda", device=dev)}
            r_args = {"a": torch.from_numpy(a).to(dev), "c": torch.from_numpy(c).to(dev)}
            fn = ring_st.functional(origin=(1, 1, 0), domain=(ring_shape[0] - 4,
                                                              ring_shape[1] - 2, ring_shape[2]))
            ms = _median_ms(lambda: fn(**r_args), reps, dev)
        else:
            sd = int(name[6:])
            ref = gspmd_single(sd, "cuda", dev)
            obj, domain, arrays, scalars = gspmd_stencil(sd, "cuda")
            tensors = {n: torch.from_numpy(v).to(dev) for n, v in arrays.items()}
            ms = _median_ms(lambda: obj.run(_domain_=domain, _origin_={
                n: (6, 6, 1) for n in tensors}, **tensors, **scalars), reps, dev)
        single[name] = {
            "equal": all(bool(np.array_equal(got[name][n], r, equal_nan=True))
                         for n, r in ref.items()),
            "max_abs_err": max(_max_err(got[name][n], r) for n, r in ref.items()),
            "finite": all(bool(np.isfinite(r).all()) for r in ref.values()),
            "single_ms": ms}
    return {"ranks": ranks, "single": single}
