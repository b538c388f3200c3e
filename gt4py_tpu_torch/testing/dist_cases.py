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
import re
import time
import traceback
from datetime import timedelta
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    FORWARD,
    PARALLEL,
    I,
    J,
    computation,
    horizontal,
    interval,
    region,
)
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
from gt4py_tpu_torch.parallel.halo import HaloExchange, _pad

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
            else:
                try:
                    results[name] = ("ok", fn(cmesh, **kw))
                except Exception:  # noqa: BLE001 -- reported as the case's failure
                    results[name] = ("error", traceback.format_exc())
            _release(cmesh.device)
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


def _release(device) -> None:
    """Give the card back the memory this rank's allocator holds unused:
    the ranks share one card with the process that launched them."""
    if device.type == "cuda":
        import gc

        gc.collect()
        torch.cuda.empty_cache()


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


@case
def exchange_jvp(cmesh, *, shape, h, periodic=(True, True), boundary="zero", wire=None,
                 seed=0, api="forward_ad"):
    """``exchange`` of a block that carries a tangent (the global array
    drawn from ``seed``, its tangent the next draw), through
    ``torch.autograd.forward_ad`` or ``torch.func.jvp`` (``api="func"``):
    the extended blocks' values and tangents, assembled x-major, and
    ``LAST_EXCHANGE``."""
    import torch.autograd.forward_ad as fwAD

    rng = np.random.default_rng(seed)
    arr, tan = rng.random(shape), rng.random(shape)
    sharding = FieldSharding(cmesh, (0, 1))
    block, tblock = distribute(sharding, arr).data, distribute(sharding, tan).data

    def ex(b):
        return halo_exchange(to_extended(cmesh, b, (h, h)), (h, h), periodic=periodic,
                             boundary=boundary, wire_dtype=_torch_dtype(wire), cmesh=cmesh)

    if api == "func":
        p, t = torch.func.jvp(ex, (block,), (tblock,))
    else:
        with fwAD.dual_level():
            p, t = fwAD.unpack_dual(ex(fwAD.make_dual(block, tblock)))
            p, t = p.detach().clone(), t.clone()
    return {"primal": _r0(cmesh, assemble(cmesh, p)), "tangent": _r0(cmesh, assemble(cmesh, t)),
            "record": dict(LAST_EXCHANGE)}


@case
def dual_exchange(cmesh, *, shape=(16, 16, 3), h=2, seed=10, periodic=(True, True)):
    """A padded block made a dual with ten times its values as its tangent,
    exchanged in place by ``HaloExchange``: this rank's largest difference
    of the tangent from ten times the values, over the whole block (the
    received halos included), and the halo's largest value."""
    import torch.autograd.forward_ad as fwAD

    block = _pad(distribute(cmesh, np.random.default_rng(seed).random(shape)).data, (h, h),
                 (0, 1))
    with fwAD.dual_level():
        d = fwAD.make_dual(block, 10.0 * block)
        HaloExchange([d], (h, h), cmesh, periodic=periodic).run()
        p, t = fwAD.unpack_dual(d)
        return {"max_diff": float((t - 10.0 * p).abs().max()), "halo_max": float(p[:h].abs().max())}


# --------------------------------------------------------------------------- #
# the models' sharded steps
# --------------------------------------------------------------------------- #


def dycore_step(cmesh, nk, ni_l, nj_l, *, dtype, backend="cuda", mode="plain",
                periodic=(True, True), boundary="zero", wire=None, options=None):
    """A sharded MiniDycore step over this rank's (K, I, J) blocks:
    ``mode`` "plain" (``shard_map_stencil``), "overlap"
    (``overlapped_shard_map_stencil`` over ``region_step_factory``) or
    "extended" (``extended_state=True``: the blocks stay halo-extended);
    ``options``: the model's stencils' build options."""
    from gt4py_tpu_torch.models.dycore import MiniDycore

    local = MiniDycore(ni_l, nj_l, nk, dtype=np.dtype(dtype), backend=backend, aligned=False,
                       device=cmesh.device, options=options)
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


def gspmd_stencil(seed: int, backend: str, options=None):
    """``gspmd_program(seed)``'s stencil object on ``backend`` (build
    ``options``), and the program's draws."""
    from gt4py_tpu_torch.cartesian import analysis as analysis_mod
    from gt4py_tpu_torch.cartesian.backend import from_name
    from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

    _, stencil, domain, arrays, scalars = gspmd_program(seed)
    an = analysis_mod.analyze(stencil)
    obj = StencilObject(analysis=an, backend=from_name(backend)(an, dict(options or {})),
                        backend_name=backend, name=stencil.name, options=dict(options or {}),
                        stencil_id=f"gspmd-{seed}")
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


def _ring_stencil(backend, **options):
    # an earlier level read at the neighbour's point, before the writer of
    # the level, which the extent analysis leaves at the domain's own points
    @gtscript.stencil(backend=backend, **options)
    def ring(a: Field64, c: Field64):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t
            with interval(1, None):
                c = t[1, 0, -1]
                t = a * 2.0

    return ring


def _chain_stencil(backend, **options):
    # a recurrence across levels and ranks: a level reads the level below
    # at the neighbouring point, so the adjoint's reversed loop reads the
    # bar of the level above at the point on the other side, which the
    # neighbouring rank computes
    @gtscript.stencil(backend=backend, **options)
    def chain(a: Field64, c: Field64):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
            with interval(1, None):
                u = t[1, 0, -1]
                t = u * a + a[0, 1, 0]
        with computation(PARALLEL), interval(...):
            c = t * a

    return chain


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
# gradients through the exchange and the global view
# --------------------------------------------------------------------------- #


def grad_weights(shape, seed: int, names=("u", "utens_stage")) -> Dict[str, np.ndarray]:
    """The weights of the outputs in a gradient case's loss."""
    rng = np.random.default_rng(seed + 100)
    return {n: rng.random(shape) for n in names}


def _assembled_grads(cmesh, leaves, grads, spatial_axes):
    return {n: assemble(cmesh, torch.zeros_like(t) if g is None else g, spatial_axes)
            for (n, t), g in zip(leaves.items(), grads)}


@case
def dycore_grad(cmesh, *, shape, dtype="float64", seed=0, mode="plain", periodic=(True, True),
                boundary="zero", wire=None, options=None):
    """The gradient of ``grad_weights``' weighted sum of one sharded
    MiniDycore step's ``u`` and ``utens_stage`` with respect to every field
    of the state drawn from ``seed``: each assembled from the ranks'
    blocks; and the last transposed exchange (``LAST_TRANSPOSE``).  Every
    rank calls the backward: the exchange's transpose is a collective."""
    from gt4py_tpu_torch.parallel.halo import LAST_TRANSPOSE

    leaves = {k: v.clone().requires_grad_()
              for k, v in _blocks(cmesh, dycore_state(shape, seed, dtype)).items()}
    _, run = _dycore_run(cmesh, shape, dtype, mode, tuple(leaves), periodic=periodic,
                         boundary=boundary, wire=wire, options=options)
    out = dict(zip(("u", "utens_stage"), run(*leaves.values())))
    weights = _blocks(cmesh, grad_weights(shape, seed))
    loss = sum((out[n] * w).sum() for n, w in weights.items())
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return _r0(cmesh, {"grads": _assembled_grads(cmesh, leaves, grads, (1, 2)),
                       "transpose": dict(LAST_TRANSPOSE)})


def _dycore_run(cmesh, shape, dtype, mode, names, **kw):
    """One sharded MiniDycore step as a function of the blocks in
    ``names`` order, returning ``u`` and ``utens_stage``; and the model."""
    nk, ni, nj = shape
    h = 3  # MiniDycore.HALO
    local, step = dycore_step(cmesh, nk, ni // cmesh.px, nj // cmesh.py, dtype=dtype,
                              mode=mode, **kw)

    def run(*blocks):
        b = dict(zip(names, blocks))
        if mode == "extended":
            b = {k: to_extended(cmesh, v, (h, h), (1, 2)) for k, v in b.items()}
        out = step(**b)
        if mode == "extended":
            out = {k: from_extended(cmesh, v, (h, h), (1, 2)) for k, v in out.items()}
        return out["u"], out["utens_stage"]

    return local, run


#: the derivative counters of a ``"cuda"`` stencil's backend
DERIVATIVE_COUNTS = ("tangent_calls", "adjoint_calls", "plain_reruns")


def derivative_counts(stencils, keys=DERIVATIVE_COUNTS) -> Dict[str, tuple]:
    """Each stencil's counters ``keys`` so far (name -> tuple)."""
    return {n: tuple(getattr(st.backend, k, 0) for k in keys) for n, st in stencils.items()}


def _counted(before: Dict[str, tuple], stencils, keys=DERIVATIVE_COUNTS) -> Dict[str, list]:
    """The counters ``keys`` since ``before`` (``derivative_counts``)."""
    return {n: [a - b for a, b in zip(c, before[n])]
            for n, c in derivative_counts(stencils, keys).items()}


def _model_counts(before, local) -> Dict[str, int]:
    """MiniDycore's stencils' derivative counters since ``before``, summed."""
    got = _counted(before, {"hdiff": local.hdiff, "vadv_update": local.vadv_upd})
    return {k: sum(c[i] for c in got.values()) for i, k in enumerate(DERIVATIVE_COUNTS)}


@case
def dycore_jvp(cmesh, *, shape, dtype="float64", seed=0, mode="plain", periodic=(True, True),
               boundary="zero", wire=None, options=None):
    """``torch.func.jvp`` of one sharded MiniDycore step at the state drawn
    from ``seed``, every field's tangent drawn as a state from ``seed +
    200``: the tangents of ``u`` and ``utens_stage`` assembled from the
    ranks' blocks, the last exchange (``LAST_EXCHANGE``, with what the
    tangents' exchange sent) and the stencils' derivative counts in the
    call."""
    state = _blocks(cmesh, dycore_state(shape, seed, dtype))
    tans = _blocks(cmesh, dycore_state(shape, seed + 200, dtype))
    names = tuple(state)
    local, run = _dycore_run(cmesh, shape, dtype, mode, names, periodic=periodic,
                             boundary=boundary, wire=wire, options=options)
    model = {"hdiff": local.hdiff, "vadv_update": local.vadv_upd}
    before = derivative_counts(model)
    _, touts = torch.func.jvp(run, tuple(state.values()), tuple(tans[n] for n in names))
    counts = _model_counts(before, local)
    return {"tangents": _r0(cmesh, _gathered(cmesh, dict(zip(("u", "utens_stage"), touts)),
                                             ("u", "utens_stage"))),
            "exchange": dict(LAST_EXCHANGE), "counts": counts}


@case
def dycore_func(cmesh, *, shape, dtype="float64", seed=0, api="grad", options=None):
    """The gradient of ``dycore_grad``'s loss through the periodic sharded
    step by ``torch.func.grad`` or ``torch.func.vjp`` (``api``), assembled
    from the ranks' blocks, and the stencils' derivative counts."""
    state = _blocks(cmesh, dycore_state(shape, seed, dtype))
    names = tuple(state)
    local, run = _dycore_run(cmesh, shape, dtype, "plain", names, options=options)
    weights = _blocks(cmesh, grad_weights(shape, seed))
    before = derivative_counts({"hdiff": local.hdiff, "vadv_update": local.vadv_upd})
    if api == "grad":
        def loss(blocks):
            u, us = run(*blocks)
            return (u * weights["u"]).sum() + (us * weights["utens_stage"]).sum()

        grads = torch.func.grad(loss)(tuple(state.values()))
    else:
        _, pull = torch.func.vjp(run, *state.values())
        grads = pull((weights["u"], weights["utens_stage"]))
    counts = _model_counts(before, local)
    return {"grads": _r0(cmesh, _assembled_grads(cmesh, state, grads, (1, 2))),
            "counts": counts}


@case
def exchange_grad_unused(cmesh, *, shape=(12, 16, 3), h=2, seed=9):
    """Two blocks through one exchange, each rank's loss reading only one
    of them (the even ranks the first, the odd ones the second): every
    rank's backward takes part in the transpose (the unused block's
    cotangent is zero). Returns the largest difference of the gradients
    from the same loss written over both blocks with zero weights."""
    rng = np.random.default_rng(seed)
    arrays = [rng.random(shape), rng.random(shape)]
    weights = [rng.random((shape[0] // cmesh.px + 2 * h, shape[1] // cmesh.py + 2 * h,
                           shape[2])) for _ in range(2)]
    mine = cmesh.rank % 2

    def grads(both):
        leaves = [distribute(cmesh, a).data.clone().requires_grad_() for a in arrays]
        ext = HaloExchange([_pad(x, (h, h), (0, 1)) for x in leaves], (h, h), cmesh).run()
        if both:
            loss = sum((e * torch.from_numpy(w * (n == mine))).sum()
                       for n, (e, w) in enumerate(zip(ext, weights)))
        else:
            loss = (ext[mine] * torch.from_numpy(weights[mine])).sum()
        return torch.autograd.grad(loss, leaves)

    return max(float((a - b).abs().max()) for a, b in zip(grads(False), grads(True)))


def _region_stencil(backend, **options):
    @gtscript.stencil(backend=backend, **options)
    def region_mix(in_f: Field64, w: Field64, out_f: Field64):
        with computation(PARALLEL), interval(...):
            out_f = w * (in_f[1, 0, 0] + in_f[-1, 0, 0] + in_f[0, 1, 0] * in_f[0, -1, 0]) - in_f
            with horizontal(region[I[0]: I[0] + 3, :], region[:, J[-1] - 2: J[-1]]):
                out_f = out_f * in_f + w[1, 0, 0]

    return region_mix


def global_grad_case(which: str, shape, seed: int, backend: str = "cuda", **options):
    """A global-view gradient case: (stencil, origin, domain, the inputs
    (I, J, K) arrays, the output's name).  ``"region"``: a stencil with
    horizontal regions, which resolve against the global domain;
    ``"hdiff"``: the MiniDycore's horizontal diffusion."""
    from gt4py_tpu_torch.models.dycore import make_hdiff

    rng = np.random.default_rng(seed)
    if which == "region":
        arrays = {"in_f": rng.random(shape), "w": rng.random(shape), "out_f": rng.random(shape)}
        return _region_stencil(backend, **options), (1, 1, 0), \
            (shape[0] - 2, shape[1] - 2, shape[2]), arrays, "out_f"
    arrays = {"in_field": rng.random(shape), "out_field": rng.random(shape),
              "coeff": 0.025 * rng.random(shape)}
    return make_hdiff(np.float64, backend, **options), (3, 3, 0), \
        (shape[0] - 6, shape[1] - 6, shape[2]), arrays, "out_field"


@case
def global_grad(cmesh, *, which="region", shape=(16, 24, 4), seed=3, backend="cuda",
                options=None):
    """The gradient of a weighted sum of a global-view call's output with
    respect to its inputs: each rank's ``DistributedField.data`` requires
    grad, the call's backward runs in the call's region frame and through
    the transposed first exchange; each gradient gathered."""
    st, origin, domain, arrays, out_name = global_grad_case(which, shape, seed, backend,
                                                            **(options or {}))
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    for f in fields.values():
        f.data.requires_grad_()
    out = st.functional(origin=origin, domain=domain)(**fields)[out_name]
    w = distribute(cmesh, np.random.default_rng(seed + 100).random(shape)).data
    grads = torch.autograd.grad((out.data * w).sum(), [f.data for f in fields.values()])
    got = {n: _gather_blocks(cmesh, _host(g), f.index, f.global_shape)
           for (n, f), g in zip(fields.items(), grads)}
    return _r0(cmesh, {"grads": got, "adjoint_calls": getattr(st.backend, "adjoint_calls", 0),
                       "plain_reruns": getattr(st.backend, "plain_reruns", 0)})


def _duals(cmesh, fields, arrays, seed: int):
    """``fields`` as DistributedFields of forward-mode duals, each tangent
    drawn from ``seed`` in ``arrays``' order (inside ``fwAD.dual_level``)."""
    import torch.autograd.forward_ad as fwAD

    rng = np.random.default_rng(seed)
    tans = {n: rng.random(np.shape(v)) for n, v in arrays.items()}
    return {n: DistributedField.from_block(
        fwAD.make_dual(f.data, distribute(cmesh, tans[n]).data.to(f.data.dtype)), f)
        for n, f in fields.items()}


def _gathered_tangents(cmesh, out) -> Dict[str, np.ndarray]:
    """The tangents of a call's written DistributedFields, gathered."""
    import torch.autograd.forward_ad as fwAD

    return {n: _gather_blocks(cmesh, _host(fwAD.unpack_dual(f.data).tangent), f.index,
                              f.global_shape) for n, f in out.items()}


@case
def global_jvp(cmesh, *, which="region", shape=(16, 24, 4), seed=3, backend="cuda",
               options=None):
    """Forward AD of a global-view call (``global_grad_case``): every input
    block a dual, the tangents drawn from ``seed + 200``; the output's
    tangent gathered, the first exchange (``LAST_EXCHANGE``) and the
    backend's tangent calls and plain re-runs in the call."""
    import torch.autograd.forward_ad as fwAD

    st, origin, domain, arrays, out_name = global_grad_case(which, shape, seed, backend,
                                                            **(options or {}))
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    counts = ("tangent_calls", "plain_reruns")
    before = {c: getattr(st.backend, c, 0) for c in counts}
    with fwAD.dual_level():
        out = st.functional(origin=origin, domain=domain)(
            **_duals(cmesh, fields, arrays, seed + 200))
        got = _gathered_tangents(cmesh, {out_name: out[out_name]})[out_name]
    return {"tangent": _r0(cmesh, got), "exchange": dict(LAST_EXCHANGE),
            **{c: getattr(st.backend, c, 0) - before[c] for c in counts}}


def _scaled_stencil(backend, **options):
    @gtscript.stencil(backend=backend, **options)
    def scaled(a: Field64, c: Field64, s: float):
        with computation(PARALLEL), interval(...):
            c = s * (a[1, 0, 0] - a[-1, 0, 0]) + a * a[0, 1, 0] * s

    return scaled


SCALED_SHAPE = (16, 24, 4)


@case
def scaled_grad(cmesh, *, seed=5, options=None):
    """A global-view call that runs from one exchange, through a tensor
    scalar ``s``: the gradient of a weighted sum of ``c`` with respect to
    ``a`` (gathered) and ``s`` (every rank's), and the tangent of ``c``
    (gathered) with tangents for ``a`` and ``s``."""
    import torch.autograd.forward_ad as fwAD

    st = _scaled_stencil("cuda", **(options or {}))
    rng = np.random.default_rng(seed)
    a, c, w, ta = (rng.random(SCALED_SHAPE) for _ in range(4))
    fn = st.functional(origin=(1, 1, 0), domain=(SCALED_SHAPE[0] - 2, SCALED_SHAPE[1] - 2,
                                                 SCALED_SHAPE[2]))
    fa, fc = distribute(cmesh, a), distribute(cmesh, c)
    s = torch.tensor(0.75, dtype=torch.float64, device=cmesh.device, requires_grad=True)
    fa.data.requires_grad_()
    out = fn(a=fa, c=fc, s=s)["c"]
    ga, gs = torch.autograd.grad((out.data * distribute(cmesh, w).data).sum(), [fa.data, s])
    with fwAD.dual_level():
        da = DistributedField.from_block(fwAD.make_dual(fa.data.detach(),
                                                        distribute(cmesh, ta).data), fa)
        ds = fwAD.make_dual(s.detach(), torch.tensor(0.5, dtype=torch.float64,
                                                     device=cmesh.device))
        tan = _gathered_tangents(cmesh, fn(a=da, c=fc, s=ds))["c"]
    return {"grad_a": _r0(cmesh, gather(DistributedField.from_block(ga, fa))),
            "grad_s": float(gs), "tangent": _r0(cmesh, tan)}


def phased_grad_case(which, backend: str = "cuda", shape=(24, 36, 5), seed: int = 0,
                     **options):
    """A phased call's gradient case: (stencil object, origins, domain, the
    inputs (I, J, K) arrays, the scalars).  ``"ring"``: the ring read
    (``_ring_stencil``), ``"chain"``: a recurrence whose adjoint runs in
    phases too (``_chain_stencil``), each on ``shape`` from ``seed``; an
    int: the generated program of that seed (``gspmd_program``)."""
    if which in ("ring", "chain"):
        rng = np.random.default_rng(seed)
        arrays = {"a": 0.5 + 0.5 * rng.random(shape), "c": rng.random(shape)}
        make = _ring_stencil if which == "ring" else _chain_stencil
        return make(backend, **options), (1, 1, 0), \
            (shape[0] - 4, shape[1] - 2, shape[2]), arrays, {}
    obj, domain, arrays, scalars = gspmd_stencil(which, backend, options)
    return obj, {n: (6, 6, 1) for n in arrays}, domain, arrays, scalars


def phased_grad_weights(arrays, written, seed: int) -> Dict[str, np.ndarray]:
    """The weights of a phased gradient case's written fields in its loss."""
    rng = np.random.default_rng(seed + 100)
    return {n: rng.random(arrays[n].shape) for n in sorted(written)}


@case
def phased_grad(cmesh, *, which="ring", seed=0, backend="cuda", options=None, emulate=None,
                shape=(24, 36, 5)):
    """The gradient of a weighted sum (``phased_grad_weights``) of a phased
    call's written fields with respect to all its fields
    (``phased_grad_case``): each rank's ``DistributedField.data``
    requires grad, the call runs in phases and its backward through the
    adjoint stencil's own global-view call (or the plain re-run), then the
    first exchange transposed; each gradient gathered, with what the call
    and its adjoint ran (``LAST_GLOBAL``) and the backend's counts in the
    call (``adjoint_calls``, ``plain_reruns``).  ``emulate``: as
    ``ring``'s."""
    import contextlib

    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL

    st, origins, domain, arrays, scalars = phased_grad_case(which, backend, shape, seed,
                                                            **(options or {}))
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    for f in fields.values():
        f.data.requires_grad_()
    counts = ("adjoint_calls", "plain_reruns")
    before = {c: getattr(st.backend, c, 0) for c in counts}
    with emulate() if emulate is not None else contextlib.nullcontext():
        out = st.functional(origin=origins, domain=domain)(**fields, **scalars)
        w = phased_grad_weights(arrays, list(out), seed)
        loss = sum((out[n].data * distribute(cmesh, w[n]).data).sum() for n in out)
        grads = torch.autograd.grad(loss, [f.data for f in fields.values()])
    got = {n: _gather_blocks(cmesh, _host(g), f.index, f.global_shape)
           for (n, f), g in zip(fields.items(), grads)}
    return _r0(cmesh, {"grads": got, "record": dict(LAST_GLOBAL),
                       **{c: getattr(st.backend, c, 0) - before[c] for c in counts}})


@case
def phased_jvp(cmesh, *, which="ring", seed=0, backend="cuda", options=None, emulate=None,
               shape=(24, 36, 5)):
    """Forward AD of a phased call (``phased_grad_case``): every field's
    block a dual, the tangents drawn from ``seed + 200``; the written
    fields' tangents gathered, what the call ran (``LAST_GLOBAL``, with its
    ``tangent``) and the backend's tangent calls and plain re-runs in the
    call.  ``emulate``: as ``ring``'s."""
    import contextlib

    import torch.autograd.forward_ad as fwAD

    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL

    st, origins, domain, arrays, scalars = phased_grad_case(which, backend, shape, seed,
                                                            **(options or {}))
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    counts = ("tangent_calls", "plain_reruns")
    before = {c: getattr(st.backend, c, 0) for c in counts}
    with emulate() if emulate is not None else contextlib.nullcontext(), fwAD.dual_level():
        out = st.functional(origin=origins, domain=domain)(
            **_duals(cmesh, fields, arrays, seed + 200), **scalars)
        got = _gathered_tangents(cmesh, out)
    return {"tangents": _r0(cmesh, got), "record": _r0(cmesh, dict(LAST_GLOBAL)),
            **{c: getattr(st.backend, c, 0) - before[c] for c in counts}}


FieldIJ64 = gtscript.Field[gtscript.IJ, np.float64]


def _lower_dim_stencil(which: str, backend: str, **options):
    """The ring read (``_ring_stencil``) through a tensor scalar
    (``"scalar"``), an I-J field it reads (``"ij_read"``) or one it
    writes (``"ij_write"``)."""
    if which == "scalar":
        @gtscript.stencil(backend=backend, **options)
        def ring_scalar(a: Field64, c: Field64, s: float):
            with computation(FORWARD):
                with interval(0, 1):
                    t = a
                    c = t
                with interval(1, None):
                    c = t[1, 0, -1] * s
                    t = a * 2.0

        return ring_scalar
    if which == "ij_read":
        @gtscript.stencil(backend=backend, **options)
        def ring_ij_read(a: Field64, h: FieldIJ64, c: Field64):
            with computation(FORWARD):
                with interval(0, 1):
                    t = a * h
                    c = t
                with interval(1, None):
                    c = t[1, 0, -1]
                    t = a * 2.0

        return ring_ij_read

    @gtscript.stencil(backend=backend, **options)
    def ring_ij_write(a: Field64, c: Field64, h: FieldIJ64):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                c = t
            with interval(1, None):
                c = t[1, 0, -1]
                t = a * 2.0
                h = h + c

    return ring_ij_write


#: the lower-dimensional rings: the inputs whose gradient is taken
LOWER_DIM_WANTED = {"scalar": ("a", "s"), "ij_read": ("a", "h"), "ij_write": ("a", "h")}


def lower_dim_case(which: str, shape=(24, 36, 5), seed: int = 0):
    """A lower-dimensional ring's inputs: the (I, J, K) and I-J arrays and
    the scalars; origin (1, 1, 0), domain ``shape`` less 4 along I and 2
    along J."""
    rng = np.random.default_rng(seed)
    arrays = {"a": 0.5 + 0.5 * rng.random(shape), "c": rng.random(shape)}
    scalars = {}
    if which == "scalar":
        scalars["s"] = 0.75
    else:
        arrays["h"] = rng.random(shape[:2])
    return arrays, scalars, (shape[0] - 4, shape[1] - 2, shape[2])


@case
def phased_lower_dim(cmesh, *, which, options=None, shape=(24, 36, 5), seed=0):
    """The gradient of a weighted sum (``phased_grad_weights``) of a
    lower-dimensional ring's written fields with respect to
    ``LOWER_DIM_WANTED[which]`` (a tensor scalar's given as a tensor): the
    fields' gradients gathered, every rank's scalar gradient, what the
    call ran (``LAST_GLOBAL``) and the backend's adjoint calls and plain
    re-runs in the call; then the written fields' tangents (gathered) with
    tangents for the same inputs, drawn from ``seed + 200``."""
    st = _lower_dim_stencil(which, "cuda", **(options or {}))
    arrays, scalars, domain = lower_dim_case(which, shape, seed)
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    scalars = {n: torch.tensor(v, dtype=torch.float64, device=cmesh.device)
               for n, v in scalars.items()}
    wanted = LOWER_DIM_WANTED[which]
    leaves = [scalars[n] if n in scalars else fields[n].data for n in wanted]
    for t in leaves:
        t.requires_grad_()
    counts = ("adjoint_calls", "plain_reruns")
    before = {c: getattr(st.backend, c) for c in counts}
    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL

    out = st.functional(origin=(1, 1, 0), domain=domain)(**fields, **scalars)
    record = dict(LAST_GLOBAL)
    w = phased_grad_weights(arrays, list(out), seed)
    loss = sum((out[n].data * distribute(cmesh, w[n]).data).sum() for n in out)
    grads = dict(zip(wanted, torch.autograd.grad(loss, leaves)))
    got = {"grads": _r0(cmesh, {n: gather(DistributedField.from_block(g, fields[n]))
                                for n, g in grads.items() if n in fields}),
           "scalars": {n: float(g) for n, g in grads.items() if n in scalars},
           "record": _r0(cmesh, {**record, **LAST_GLOBAL}),
           **{c: getattr(st.backend, c) - before[c] for c in counts}}
    # forward AD with tangents for the same inputs (drawn from seed + 200)
    import torch.autograd.forward_ad as fwAD

    rng = np.random.default_rng(seed + 200)
    tans = {n: rng.random(np.shape({**arrays, **scalars}[n])) for n in wanted}
    with fwAD.dual_level():
        duals = {n: DistributedField.from_block(fwAD.make_dual(
            f.data.detach(), distribute(cmesh, tans[n]).data), f) if n in tans else f
            for n, f in fields.items()}
        duals.update({n: fwAD.make_dual(s.detach(), torch.tensor(tans[n], dtype=torch.float64,
                                                                 device=cmesh.device))
                      for n, s in scalars.items()})
        got["tangents"] = _r0(cmesh, _gathered_tangents(
            cmesh, st.functional(origin=(1, 1, 0), domain=domain)(**duals)))
    return got


@case
def phased_while_grad(cmesh, *, seed=11203, backend="cuda"):
    """A gradient through a phased call that iterates a ``while`` (the
    generated program of ``seed``): the error it raises, on every rank."""
    st, origins, domain, arrays, scalars = phased_grad_case(seed, backend)
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    fields["in0"].data.requires_grad_()
    try:
        st.functional(origin=origins, domain=domain)(**fields, **scalars)
    except NotImplementedError as e:
        return str(e)
    return None


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


@case
def next_derivatives(cmesh, *, mode="global", seed=13):
    """``wide`` on sharded fields (``mode="global"``: called on
    ``ShardedField``s; ``"shard_map"``: ``shard_map_operator``, periodic):
    the gradient of a weighted sum of its output with respect to both
    inputs (autograd), and the output's tangent with tangents for both
    (forward AD), each gathered.  The inputs, their tangents and the
    weights are drawn from ``seed`` in that order."""
    import torch.autograd.forward_ad as fwAD

    from gt4py_tpu_torch.next import distributed as nxd

    o = next_ops()
    rng = np.random.default_rng(seed)
    a, b, ta, tb = (rng.random((16, 32)) for _ in range(4))
    dmap = {o["I"]: "x", o["J"]: "y"}

    def field(x):
        return nxd.distribute(o["gtx"].as_field((o["I"], o["J"]), x, device=cmesh.device),
                              cmesh, dmap)

    def dual(f, t):
        return nxd.ShardedField(f.domain, fwAD.make_dual(f.data, field(t).data), f.placement,
                                f.block_index)

    def gathered(f, t):
        return _gather_blocks(cmesh, _host(t), f.block_index, f.global_shape)

    step = o["wide"] if mode == "global" else nxd.shard_map_operator(o["wide"], cmesh, dmap)
    fa, fb = field(a), field(b)
    fa.data.requires_grad_()
    fb.data.requires_grad_()
    out = step(fa, fb)
    w = rng.random(out.global_shape)
    wb = torch.from_numpy(w[tuple(slice(lo, hi) for lo, hi in out.block_index)]).to(cmesh.device)
    grads = torch.autograd.grad((out.data * wb).sum(), [fa.data, fb.data])
    with fwAD.dual_level():
        tout = step(dual(field(a), ta), dual(field(b), tb))
        tangent = gathered(tout, fwAD.unpack_dual(tout.data).tangent)
    return _r0(cmesh, {"grads": [gathered(f, g) for f, g in zip((fa, fb), grads)],
                       "tangent": tangent, "ranges": [(r.start, r.stop)
                                                      for r in out.domain.ranges]})


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
    from gt4py_tpu_torch.parallel import halo_comm_bytes

    t0 = time.perf_counter()
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
    out["seconds"] = time.perf_counter() - t0
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


@case
def chip_grads(cmesh, *, shape=(80, 512, 512), seed=4, reps=5):
    """The chip check's phase 15 gradients (see ``chip_smoke.py``), float64
    on every rank: the sharded MiniDycore step's gradient
    (``shard_map_stencil``, periodic) and a global-view hdiff call's (on
    DistributedFields, its derivative stencils in the call's region
    frame), each rank's backward through the transposed exchange, with the
    adjoint calls and plain re-runs of each stencil; each rank's forward
    and transposed exchange of the step's five halo-extended blocks (host
    clock, median of ``reps``) and their bytes; rank 0 holds both
    gradients to the single-device ones on the card.  Then forward mode:
    ``torch.func.jvp`` of the sharded step and forward AD of the global-view
    hdiff (every state field's tangent drawn from ``seed + 200``), each
    rank's tangent calls, plain re-runs and tangent kernels' launches, the
    exchange's tangent bytes, its forward and forward + tangent times (CUDA
    events, median of ``reps``) and rank 0's tangent kernels' device time
    (``torch.profiler``, one call); rank 0 holds both tangents to the
    single-device ones on the card."""
    import torch.autograd.forward_ad as fwAD

    from gt4py_tpu_torch.models.dycore import MiniDycore
    from gt4py_tpu_torch.parallel.halo import LAST_TRANSPOSE

    t0 = time.perf_counter()
    dev = cmesh.device
    nk, ni, nj = shape
    h = MiniDycore.HALO
    names = tuple(n for n, _ in DYCORE_FIELDS)
    state = dycore_state(shape, seed, "float64")
    weights = grad_weights(shape, seed)
    out: Dict[str, Any] = {"rank": cmesh.rank}

    # 1. the sharded step's gradient
    local, step = dycore_step(cmesh, nk, ni // cmesh.px, nj // cmesh.py, dtype="float64")
    stencils = {"hdiff": local.hdiff, "vadv_update": local.vadv_upd}
    before = derivative_counts(stencils, ("adjoint_calls", "plain_reruns"))
    leaves = {k: v.clone().requires_grad_() for k, v in _blocks(cmesh, state).items()}
    new = step(**leaves)
    wb = _blocks(cmesh, weights)
    grads = torch.autograd.grad(sum((new[n] * w).sum() for n, w in wb.items()),
                                list(leaves.values()))
    _sync(dev)
    out["step_adjoint"] = _counted(before, stencils, ("adjoint_calls", "plain_reruns"))
    out["step_transpose"] = dict(LAST_TRANSPOSE)
    sharded = _assembled_grads(cmesh, leaves, grads, (1, 2))
    # 2. the exchange and its transpose on the step's blocks
    pads = [_pad(leaves[n].detach(), (h, h), (1, 2)) for n in names]
    cots = [torch.rand_like(p) for p in pads]
    kw = dict(spatial_axes=(1, 2))
    out["exchange_ms"] = _median_host_ms(lambda: HaloExchange(pads, (h, h), cmesh, **kw).run(),
                                         reps, dev)
    out["exchange"] = dict(LAST_EXCHANGE)
    out["transpose_ms"] = _median_host_ms(
        lambda: HaloExchange(pads, (h, h), cmesh, **kw).transpose(cots), reps, dev)
    out["transpose"] = dict(LAST_TRANSPOSE)
    # 3. the global view's hdiff
    st, origin, domain, arrays, out_name = global_grad_case("hdiff", (ni, nj, nk), seed)
    before = derivative_counts({"hdiff": st}, ("adjoint_calls", "plain_reruns"))
    fields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    for f in fields.values():
        f.data.requires_grad_()
    w = distribute(cmesh, np.random.default_rng(seed + 100).random((ni, nj, nk))).data
    res = st.functional(origin=origin, domain=domain)(**fields)[out_name]
    ggrads = torch.autograd.grad((res.data * w).sum(), [f.data for f in fields.values()])
    _sync(dev)
    out["global_adjoint"] = _counted(before, {"hdiff": st}, ("adjoint_calls", "plain_reruns"))["hdiff"]
    out["global_transpose"] = dict(LAST_TRANSPOSE)
    global_got = {n: _gather_blocks(cmesh, _host(g), f.index, f.global_shape)
                  for (n, f), g in zip(fields.items(), ggrads)}
    # 4. forward mode: torch.func.jvp of the sharded step (the tangent
    # stencils, the exchanges carrying the tangents), then forward AD of the
    # global-view hdiff
    blocks = _blocks(cmesh, state)
    tblocks = _blocks(cmesh, dycore_state(shape, seed + 200, "float64"))

    def run(*xs):
        new = step(**dict(zip(names, xs)))
        return new["u"], new["utens_stage"]

    def step_jvp():
        return torch.func.jvp(run, tuple(blocks[n] for n in names),
                              tuple(tblocks[n] for n in names))[1]

    before, launched = derivative_counts(stencils, ("tangent_calls", "plain_reruns")), tangent_launches(stencils)
    touts = step_jvp()
    _sync(dev)
    out["step_tangent"] = _counted(before, stencils, ("tangent_calls", "plain_reruns"))
    out["step_tangent_launches"] = tangent_launches(stencils) - launched
    out["step_tangent_exchange"] = dict(LAST_EXCHANGE)
    step_tangents = _gathered(cmesh, dict(zip(("u", "utens_stage"), touts)),
                              ("u", "utens_stage"))
    out["step_f64_ms"] = _median_ms(lambda: step(**blocks), reps, dev)
    out["step_jvp_ms"] = _median_ms(step_jvp, reps, dev)
    out["step_tangent_kernel_ms"] = _kernel_ms(cmesh, step_jvp, "__tan")
    trng = np.random.default_rng(seed + 200)
    gtans = {n: distribute(cmesh, trng.random(v.shape)).data for n, v in arrays.items()}
    gfields = {n: distribute(cmesh, v) for n, v in arrays.items()}
    gfn = st.functional(origin=origin, domain=domain)

    def global_jvp():
        with fwAD.dual_level():
            res = gfn(**{n: DistributedField.from_block(fwAD.make_dual(f.data, gtans[n]), f)
                         for n, f in gfields.items()})[out_name]
            return DistributedField.from_block(fwAD.unpack_dual(res.data).tangent, res)

    before = derivative_counts({"hdiff": st}, ("tangent_calls", "plain_reruns"))
    launched = tangent_launches({"hdiff": st})
    gtan = global_jvp()
    _sync(dev)
    out["global_tangent"] = _counted(before, {"hdiff": st}, ("tangent_calls", "plain_reruns"))["hdiff"]
    out["global_tangent_launches"] = tangent_launches({"hdiff": st}) - launched
    out["global_tangent_exchange"] = dict(LAST_EXCHANGE)
    global_tangent = gather(gtan)
    out["global_ms"] = _median_ms(lambda: gfn(**gfields), reps, dev)
    out["global_jvp_ms"] = _median_ms(global_jvp, reps, dev)
    out["seconds"] = time.perf_counter() - t0
    ranks = [None] * cmesh.size
    dist.all_gather_object(ranks, out)
    if cmesh.rank != 0:
        return out
    _release(dev)
    # rank 0: the single-device gradients on the card
    single = MiniDycore(ni, nj, nk, dtype=np.float64, aligned=False, device=dev)
    g0 = {k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in state.items()}
    padded = {k: torch.nn.functional.pad(v[None], (h, h, h, h), mode="circular")[0]
              for k, v in g0.items()}
    o1 = single.step_fn(fill_halos=False)(padded)
    loss = sum((o1[n][:, h:h + ni, h:h + nj] * torch.from_numpy(w).to(dev)).sum()
               for n, w in weights.items())
    ref = dict(zip(g0, (_host(g) for g in torch.autograd.grad(loss, list(g0.values())))))
    t = {k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in arrays.items()}
    res1 = st.functional(origin=origin, domain=domain)(**t)[out_name]
    wt = torch.from_numpy(np.random.default_rng(seed + 100).random((ni, nj, nk))).to(dev)
    gref = dict(zip(t, (_host(g) for g in torch.autograd.grad((res1 * wt).sum(),
                                                                 list(t.values())))))
    step1 = single.step_fn(fill_halos=False)
    tstate = dycore_state(shape, seed + 200, "float64")

    def single_run(*xs):
        o = step1({k: torch.nn.functional.pad(v[None], (h, h, h, h), mode="circular")[0]
                   for k, v in zip(names, xs)})
        return tuple(o[n][:, h:h + ni, h:h + nj] for n in ("u", "utens_stage"))

    _, tref = torch.func.jvp(single_run, tuple(torch.from_numpy(state[n]).to(dev)
                                               for n in names),
                             tuple(torch.from_numpy(tstate[n]).to(dev) for n in names))
    tref = dict(zip(("u", "utens_stage"), (_host(x) for x in tref)))
    trng = np.random.default_rng(seed + 200)
    with fwAD.dual_level():
        duals = {k: fwAD.make_dual(torch.from_numpy(v).to(dev),
                                   torch.from_numpy(trng.random(v.shape)).to(dev))
                 for k, v in arrays.items()}
        gtref = _host(fwAD.unpack_dual(st.functional(origin=origin, domain=domain)(
            **duals)[out_name]).tangent)

    def compare(got, want):
        return {n: {"max_abs_err": _max_err(got[n], r), "largest": float(np.abs(r).max()),
                    "close": bool(np.allclose(got[n], r, rtol=1e-12,
                                              atol=1e-12 * float(np.abs(r).max()))),
                    "finite": bool(np.isfinite(got[n]).all())}
                for n, r in want.items()}

    return {"ranks": ranks, "step": compare(sharded, ref), "global": compare(global_got, gref),
            "step_tangent": compare(step_tangents, tref),
            "global_tangent": compare({out_name: global_tangent}, {out_name: gtref})}


def tangent_launches(stencils) -> int:
    """The launches the stencils' tangent stencils' libraries counted so
    far (zero before they are loaded)."""
    return sum(b.device_launches()["all"] for st in stencils.values()
               for b in st.backend.derivative_backends()["tangent"])


def _kernel_ms(cmesh, fn, tag: str):
    """One call of ``fn`` on every rank (a collective), rank 0's under
    ``torch.profiler``: the device time of its kernels whose name holds
    ``tag``, summed by kernel (ms), on the card; None elsewhere."""
    if cmesh.rank != 0 or cmesh.device.type != "cuda":
        fn()
        _sync(cmesh.device)
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(cmesh.device)
    ms: Dict[str, float] = {}
    for e in prof.key_averages():
        name = re.search(r"\w*" + re.escape(tag) + r"\w*", e.key)
        if name is not None:
            ms[name.group(0)] = ms.get(name.group(0), 0.0) + getattr(
                e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
    return ms


#: the phased calls of the chip check's phase 15: the ring (I, J, K) and
#: the generated programs that read a neighbour's writes of the call
PHASED_RING_SHAPE = (512, 512, 80)
PHASED_SEEDS = (11203, 11238)


@case
def chip_phased(cmesh, *, ring_shape=PHASED_RING_SHAPE, seeds=PHASED_SEEDS, reps=3):
    """The chip check's phased calls on every rank (see ``chip_smoke.py``,
    phase 15): the ring stencil (float64, one level at a time) and the
    programs ``seeds`` (a ``while`` iterated across the ranks, a serial
    loop a level at a time) on ``"cuda"`` on DistributedFields, each
    rank's kernel launches read from the stencil libraries around its
    call, what the call ran (``LAST_GLOBAL``, its phases' kernel time
    from the last timed call), its time (CUDA events, median of ``reps``);
    rank 0 holds each to the single-device ``"cuda"`` run on the card, bit
    for bit, and times that too.  Then the gradients of the ring and of the
    chain (``_chain_stencil``, whose adjoint runs in phases too) on the same
    inputs (``ring_grad``, ``chain_grad``: the weighted sum of ``c`` with
    respect to ``a`` and ``c``, forward and backward timed together and the
    chain's forward alone, the adjoint calls and plain re-runs of the call,
    ``LAST_GLOBAL`` with its ``adjoint``), which rank 0 holds to the
    single-device gradients on the card at rtol 1e-12 of the largest
    entry (``grads``).  Then forward AD of the ring (``ring_jvp``: its
    tangent stencil's phased global-view call, tangents drawn from 200; its
    forward + tangent time, tangent calls and plain re-runs) and the ring's
    gradients through a tensor scalar and an I-J field it reads
    (``scalar_grad``, ``ij_read_grad``: ``_lower_dim_stencil``, every rank's
    scalar gradient), each held by rank 0 to the single-device card result
    at rtol 1e-12 of the largest entry (``grads``)."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN, library_launches
    from gt4py_tpu_torch.parallel.distributed import LAST_GLOBAL, _plan_of

    t0 = time.perf_counter()
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
    # the gradients of the ring and the chain: the phased forward, then the
    # adjoint stencil's own global-view call (the chain's itself phased) and
    # the first exchange's transpose
    w = phased_grad_weights({"c": a}, ["c"], 0)["c"]
    wd = distribute(cmesh, w).data
    counts = ("adjoint_calls", "plain_reruns")
    grad_sts = {"ring": ring_st, "chain": _chain_stencil("cuda")}
    grads = {}
    for name, st in grad_sts.items():
        fn = ring_fn if name == "ring" else st.functional(origin=(1, 1, 0), domain=(
            ring_shape[0] - 4, ring_shape[1] - 2, ring_shape[2]))

        def grad_call(fn=fn):
            fs = {"a": distribute(cmesh, a), "c": distribute(cmesh, c)}
            for f in fs.values():
                f.data.requires_grad_()
            res = fn(**fs)["c"]
            return fs, torch.autograd.grad((res.data * wd).sum(), [f.data for f in fs.values()])

        before = {k: getattr(st.backend, k) for k in counts}
        fs, g = grad_call()
        _sync(dev)
        rec = {**LAST_GLOBAL, **{k: getattr(st.backend, k) - before[k] for k in counts}}
        grads[name] = {n: _gather_blocks(cmesh, _host(x), f.index, f.global_shape)
                       for (n, f), x in zip(fs.items(), g)}
        rec["ms"] = _median_ms(grad_call, reps, dev)
        if name == "chain":  # the ring's forward alone is timed above
            fwd_args = {"a": distribute(cmesh, a), "c": distribute(cmesh, c)}
            rec["forward_ms"] = _median_ms(lambda fn=fn: fn(**fwd_args), reps, dev)
        out[f"{name}_grad"] = rec
    # forward AD of the ring: its tangent stencil's global-view call, phased
    # as the ring is
    import torch.autograd.forward_ad as fwAD

    trng = np.random.default_rng(200)
    ta, tc = trng.random(ring_shape), trng.random(ring_shape)
    tblocks = {"a": distribute(cmesh, ta).data, "c": distribute(cmesh, tc).data}

    def ring_jvp():
        with fwAD.dual_level():
            fs = {n: DistributedField.from_block(fwAD.make_dual(f.data, tblocks[n]), f)
                  for n, f in ring_args.items()}
            res = ring_fn(**fs)["c"]
            return DistributedField.from_block(fwAD.unpack_dual(res.data).tangent, res)

    tcounts = ("tangent_calls", "plain_reruns")
    before = {k: getattr(ring_st.backend, k) for k in tcounts}
    ring_tangent = gather(ring_jvp())
    _sync(dev)
    rec = {**LAST_GLOBAL, **{k: getattr(ring_st.backend, k) - before[k] for k in tcounts}}
    rec["ms"] = _median_ms(ring_jvp, reps, dev)
    out["ring_jvp"] = rec
    # the ring's gradients through a tensor scalar and an I-J field it reads
    lower = {}
    for which in ("scalar", "ij_read"):
        lst = _lower_dim_stencil(which, "cuda")
        arrays, scalars, domain = lower_dim_case(which, ring_shape)
        lfn = lst.functional(origin=(1, 1, 0), domain=domain)
        wanted = LOWER_DIM_WANTED[which]
        wl = phased_grad_weights(arrays, ["c"], 0)["c"]
        wld = distribute(cmesh, wl).data

        def lower_grad(lfn=lfn, arrays=arrays, scalars=scalars, wanted=wanted, wld=wld):
            fs = {n: distribute(cmesh, v) for n, v in arrays.items()}
            sc = {n: torch.tensor(v, dtype=torch.float64, device=dev)
                  for n, v in scalars.items()}
            leaves = [sc[n] if n in sc else fs[n].data for n in wanted]
            for t in leaves:
                t.requires_grad_()
            res = lfn(**fs, **sc)["c"]
            return fs, dict(zip(wanted, torch.autograd.grad((res.data * wld).sum(), leaves)))

        before = {k: getattr(lst.backend, k) for k in counts}
        fs, g = lower_grad()
        _sync(dev)
        rec = {**LAST_GLOBAL, **{k: getattr(lst.backend, k) - before[k] for k in counts}}
        lower[which] = {n: (float(x) if n in scalars else gather(
            DistributedField.from_block(x, fs[n]))) for n, x in g.items()}
        rec["scalars"] = {n: float(x) for n, x in g.items() if n in scalars}
        rec["ms"] = _median_ms(lower_grad, reps, dev)
        out[f"{which}_grad"] = rec
    out["seconds"] = time.perf_counter() - t0
    ranks = [None] * cmesh.size
    dist.all_gather_object(ranks, out)
    if cmesh.rank != 0:
        return out
    _release(dev)
    # rank 0: the single-device gradients on the card
    wt = torch.from_numpy(w).to(dev)
    grad_recs = {}
    for name, st in grad_sts.items():
        one = st.functional(origin=(1, 1, 0),
                            domain=(ring_shape[0] - 4, ring_shape[1] - 2, ring_shape[2]))

        def single_grad(one=one):
            t = {"a": torch.from_numpy(a).to(dev).requires_grad_(),
                 "c": torch.from_numpy(c).to(dev).requires_grad_()}
            return dict(zip(t, torch.autograd.grad((one(**t)["c"] * wt).sum(),
                                                   list(t.values()))))

        ref = {n: _host(v) for n, v in single_grad().items()}
        got_g = grads[name]
        grad_recs[name] = {
            "max_abs_err": max(_max_err(got_g[n], r) for n, r in ref.items()),
            "largest": max(float(np.abs(r).max()) for r in ref.values()),
            "equal": all(bool(np.array_equal(got_g[n], r)) for n, r in ref.items()),
            "close": all(bool(np.allclose(got_g[n], r, rtol=1e-12,
                                          atol=1e-12 * float(np.abs(r).max())))
                         for n, r in ref.items()),
            "finite": all(bool(np.isfinite(got_g[n]).all()) for n in ref),
            "single_ms": _median_ms(single_grad, reps, dev),
            "adjoint_plan": {k: LAST_PLAN.get(f"{name}__adj", {}).get(k)
                             for k in ("forms", "declined")}}
    one = ring_st.functional(origin=(1, 1, 0), domain=(ring_shape[0] - 4, ring_shape[1] - 2,
                                                       ring_shape[2]))
    with fwAD.dual_level():
        res = one(a=fwAD.make_dual(torch.from_numpy(a).to(dev), torch.from_numpy(ta).to(dev)),
                  c=fwAD.make_dual(torch.from_numpy(c).to(dev), torch.from_numpy(tc).to(dev)))
        tref = _host(fwAD.unpack_dual(res["c"]).tangent)
    grad_recs["ring_jvp"] = _close({"c": ring_tangent}, {"c": tref})
    for which, got_l in lower.items():
        lst = _lower_dim_stencil(which, "cuda")
        arrays, scalars, domain = lower_dim_case(which, ring_shape)
        t = {n: torch.from_numpy(v).to(dev) for n, v in arrays.items()}
        sc = {n: torch.tensor(v, dtype=torch.float64, device=dev) for n, v in scalars.items()}
        wanted = LOWER_DIM_WANTED[which]
        leaves = [sc[n] if n in sc else t[n] for n in wanted]
        for x in leaves:
            x.requires_grad_()
        res = lst.functional(origin=(1, 1, 0), domain=domain)(**t, **sc)["c"]
        wl = torch.from_numpy(phased_grad_weights(arrays, ["c"], 0)["c"]).to(dev)
        ref = dict(zip(wanted, (np.asarray(_host(x)) for x in torch.autograd.grad(
            (res * wl).sum(), leaves))))
        grad_recs[f"{which}_grad"] = _close({n: np.asarray(v) for n, v in got_l.items()}, ref)
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
    return {"ranks": ranks, "single": single, "grads": grad_recs}


def _close(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> dict:
    """``got`` against ``want`` over all their arrays, at rtol 1e-12 of the
    largest entry."""
    largest = max(float(np.abs(r).max()) for r in want.values())
    return {"max_abs_err": max(_max_err(np.asarray(got[n]), np.asarray(r))
                               for n, r in want.items()),
            "largest": largest,
            "equal": all(bool(np.array_equal(got[n], r)) for n, r in want.items()),
            "close": all(bool(np.allclose(got[n], r, rtol=1e-12, atol=1e-12 * largest))
                         for n, r in want.items()),
            "finite": all(bool(np.isfinite(got[n]).all()) for n in want)}
