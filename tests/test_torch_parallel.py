"""The port's distribution layer on four gloo ranks (a 2x2 mesh) on the CPU,
held to the JAX package's ``gt4py_tpu.parallel`` on its virtual CPU devices.

One module-scoped launch (``testing.dist_cases.launch``) runs every case
on the ranks; each test compares one case.  Pure data movement (exchanges,
wire casts, extended round trips) is held bit for bit, steps that compute
at rtol = atol = 1e-12 in float64.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

from gt4py_tpu_torch import config
from gt4py_tpu_torch.testing import dist_cases

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401

DYCORE = (5, 16, 32)
#: more generated programs on DistributedFields, each exact; 11203 and
#: 11238 read what a neighbouring rank writes during the call, and run in
#: phases (a ``while`` iterated across the ranks, a BACKWARD loop a level
#: at a time)
GSPMD_MORE = (*range(11006, 11030), 11203, 11238)
GSPMD_CROSS_RANK = (11203, 11238)

CASES = {
    "exchange_periodic": dict(case="exchange", shape=(8, 8), h=1, seed=4),
    "exchange_kij": dict(case="exchange", shape=(3, 12, 16), h=2, seed=6,
                         spatial_axes=(1, 2)),
    "exchange_zero": dict(case="exchange", shape=(12, 12), h=2, seed=3,
                          periodic=(False, False)),
    "exchange_clamp": dict(case="exchange", shape=(12, 12), h=2, seed=3,
                           periodic=(False, False), boundary="clamp"),
    "exchange_mixed": dict(case="exchange", shape=(12, 12), h=2, seed=8,
                           periodic=(True, False), boundary="clamp"),
    "wire_f32": dict(case="exchange", shape=(16, 16), h=2, seed=5, dtype="float32",
                     wire="bfloat16"),
    "wire_f64": dict(case="exchange", shape=(16, 16), h=2, seed=5, wire="bfloat16"),
    "dycore": dict(shape=(6, 16, 32), seed=0),
    "dycore_plain": dict(case="dycore", shape=DYCORE, seed=0),
    "dycore_overlap": dict(case="dycore", shape=DYCORE, seed=0, mode="overlap"),
    "dycore_plain_open": dict(case="dycore", shape=DYCORE, seed=0, periodic=(False, False),
                              boundary="clamp"),
    "dycore_overlap_open": dict(case="dycore", shape=DYCORE, seed=0, mode="overlap",
                                periodic=(False, False), boundary="clamp"),
    "dycore_two": dict(case="dycore", shape=DYCORE, seed=0, steps=2),
    "dycore_extended": dict(case="dycore", shape=DYCORE, seed=0, steps=2, mode="extended"),
    "dycore_wire": dict(case="dycore", shape=(4, 32, 32), seed=1,
                        wire="bfloat16", compare_single=True),
    "fv": dict(shape=(4, 16, 32)),
    "shallow_water": dict(shape=(3, 16, 32)),
    "global_laplacian": dict(),
    "shard_map_laplacian": dict(),
    "serial_k": dict(),
    **{f"gspmd_{s}": dict(case="gspmd", seed=s) for s in range(11000, 11006)},
    **{f"gspmd_{s}": dict(case="gspmd_or_decline", seed=s) for s in GSPMD_MORE},
    **{f"undeclined_{s}": dict(case="gspmd_undeclined", seed=s) for s in GSPMD_CROSS_RANK},
    "ring": dict(backend="torch"),
    "chip_distribution": dict(shape=(4, 32, 32), steps=1, reps=1, gspmd_seeds=(11000,)),
}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


@contextlib.contextmanager
def _emulated_kernels(cxx, d):
    """On a rank: ``backend="cuda"`` on CPU tensors runs the generated
    kernels, built by the host compiler against the emulated runtime of
    ``test_torch_emulated`` (the ``emulated`` fixture's patches, with each
    library written whole, as the ranks build at once)."""
    from gt4py_tpu_torch.cartesian.backend import _build, cuda_backend

    from .test_torch_emulated import _LAUNCH, EMULATED_BF16, EMULATED_FP16, _Stream

    def build(source, name):
        src = _LAUNCH.sub(r"GT_EMULATED_LAUNCH(grid, block, \2, \1, \3);", source)
        out = os.path.join(d, hashlib.sha256(src.encode() + _build._runtime_header().encode()
                                              + EMULATED_FP16.encode()
                                              + EMULATED_BF16.encode()).hexdigest())
        lib = os.path.join(out, f"lib{name}.so")
        if not os.path.exists(lib):
            os.makedirs(out, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".cpp", dir=out)
            with os.fdopen(fd, "w") as f:
                f.write(src)
            proc = subprocess.run(
                [cxx, "-std=c++17", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-I", d,
                 "-I", _build.RUNTIME_DIR, "-o", tmp + ".so", tmp], capture_output=True,
                text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
            os.replace(tmp + ".so", lib)
        return ctypes.CDLL(lib), out

    import torch

    saved = (_build.build, torch.cuda.device, torch.cuda.current_stream,
             cuda_backend.CudaBackend.apply)
    _build.build = build
    torch.cuda.device = lambda device: contextlib.nullcontext()
    torch.cuda.current_stream = lambda device=None: _Stream()
    cuda_backend.CudaBackend.apply = cuda_backend.CudaBackend.run_kernels
    try:
        yield
    finally:
        (_build.build, torch.cuda.device, torch.cuda.current_stream,
         cuda_backend.CudaBackend.apply) = saved


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four gloo ranks; with a host C++ compiler also the
    ring on the emulated kernels (``ring_cuda``)."""
    from .test_torch_emulated import EMULATED_BF16, EMULATED_FP16, EMULATED_RUNTIME

    cases = dict(CASES)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is not None:
        d = tmp_path_factory.mktemp("emulated_ranks")
        for header, text in (("cuda_runtime.h", EMULATED_RUNTIME), ("cuda_fp16.h", EMULATED_FP16),
                             ("cuda_bf16.h", EMULATED_BF16)):
            (d / header).write_text(text)
        cases["ring_cuda"] = dict(case="ring", backend="cuda",
                                  emulate=functools.partial(_emulated_kernels, cxx, str(d)))
    return dist_cases.launch(cases, workdir=str(tmp_path_factory.mktemp("ranks")))


def result(ranks, name):
    """Rank 0's result of case ``name``; every rank must have passed."""
    for status, res in ranks[name]:
        assert status == "ok", res
    return ranks[name][0][1]


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from gt4py_tpu.parallel import CartesianMesh

    assert len(jax.devices()) >= 4
    return CartesianMesh((2, 2))


def jax_exchange(jmesh, arr, h, spatial_axes=(0, 1), **kw):
    import jax
    from jax.sharding import PartitionSpec as P

    from gt4py_tpu.parallel import halo_exchange, to_extended

    spec = P(*[("x" if a == spatial_axes[0] else "y" if a == spatial_axes[1] else None)
               for a in range(arr.ndim)])
    ext = to_extended(jmesh, jax.device_put(arr, jmesh.field_sharding(arr.ndim))
                      if spatial_axes == (0, 1) else
                      jax.device_put(arr, jax.sharding.NamedSharding(jmesh.mesh, spec)),
                      (h, h), spatial_axes)
    return np.asarray(jax.shard_map(
        lambda b: halo_exchange(b, (h, h), spatial_axes=spatial_axes, **kw), mesh=jmesh.mesh,
        in_specs=(spec,), out_specs=spec, check_vma=False)(ext))


# --------------------------------------------------------------------------- #
# halo exchange
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["exchange_periodic", "exchange_kij", "exchange_zero",
                                  "exchange_clamp", "exchange_mixed"])
def test_exchange_matches_jax(ranks, jmesh, name):
    """Periodic, open (zero and clamp) and mixed boundaries, logical and
    K-leading layouts: every rank's extended block equals the JAX
    package's bit for bit."""
    p = CASES[name]
    arr = np.random.default_rng(p["seed"]).random(p["shape"])
    want = jax_exchange(jmesh, arr, p["h"], p.get("spatial_axes", (0, 1)),
                        periodic=p.get("periodic", (True, True)),
                        boundary=p.get("boundary", "zero"))
    got = result(ranks, name)
    np.testing.assert_array_equal(got["ext"], want)
    assert got["record"]["backend"] == "gloo" and not got["record"]["staged"]


@pytest.mark.parametrize("name", ["wire_f32", "wire_f64"])
def test_bf16_wire_matches_jax(ranks, jmesh, name):
    """A bfloat16 wire: the strips round once on the way, as the JAX
    package's exchange rounds them (float64 strips included), and the
    record counts half (float32) or a quarter (float64) of the bytes."""
    import jax.numpy as jnp

    from gt4py_tpu.parallel import halo_comm_bytes as jax_bytes
    from gt4py_tpu_torch.parallel import halo_comm_bytes

    p = CASES[name]
    arr = np.random.default_rng(p["seed"]).random(p["shape"]).astype(p.get("dtype", "float64"))
    want = jax_exchange(jmesh, arr, p["h"], wire_dtype=jnp.bfloat16)
    got = result(ranks, name)
    np.testing.assert_array_equal(got["ext"], want)
    h, ni_e = p["h"], p["shape"][0] // 2 + 2 * p["h"]
    full = jax_exchange(jmesh, arr, h)
    assert not np.array_equal(got["ext"], full)
    rec = got["record"]
    assert rec["wire_dtype"] == "bfloat16" and rec["strips"] == 4
    import torch

    nbytes = halo_comm_bytes((ni_e, ni_e), (h, h), arr.dtype, wire_dtype=torch.bfloat16)
    assert rec["bytes"] == nbytes == jax_bytes((ni_e, ni_e), (h, h), arr.dtype,
                                               wire_dtype=jnp.bfloat16)
    assert nbytes * arr.dtype.itemsize // 2 == halo_comm_bytes((ni_e, ni_e), (h, h), arr.dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spatial_axes,shape", [((0, 1), (14, 22)), ((1, 2), (5, 14, 22))])
def test_halo_comm_bytes_matches_jax(dtype, spatial_axes, shape):
    import jax.numpy as jnp
    import torch

    from gt4py_tpu.parallel import halo_comm_bytes as jax_bytes
    from gt4py_tpu_torch.parallel import halo_comm_bytes

    for wire, jwire in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        assert halo_comm_bytes(shape, (3, 2), dtype, spatial_axes, wire, n_fields=5) == \
            jax_bytes(shape, (3, 2), dtype, spatial_axes, jwire, n_fields=5)


# --------------------------------------------------------------------------- #
# sharded model steps
# --------------------------------------------------------------------------- #


def jax_dycore(jmesh, shape, seed, *, steps=1, periodic=(True, True), boundary="zero",
               dtype=np.float64, wire=None):
    """The JAX package's sharded MiniDycore steps on the 2x2 mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.models.dycore import MiniDycore
    from gt4py_tpu.parallel import gather, shard_map_stencil

    nk, ni, nj = shape
    local = MiniDycore(ni // 2, nj // 2, nk, dtype=dtype, backend="jax", aligned=False)
    lstep = local.step_fn(fill_halos=False)
    h = MiniDycore.HALO
    state = dist_cases.dycore_state(shape, seed, dtype)
    step = shard_map_stencil(lambda **kw: lstep(dict(kw)), jmesh, (h, h),
                             field_names=tuple(state), spatial_axes=(1, 2), periodic=periodic,
                             boundary=boundary, halo_wire_dtype=wire)
    sharding = NamedSharding(jmesh.mesh, P(None, "x", "y"))
    g = {k: jax.device_put(v, sharding) for k, v in state.items()}
    run = jax.jit(lambda **kw: step(**kw))
    for _ in range(steps):
        g = run(**g)
    return {n: gather(g[n]) for n in ("u", "utens_stage")}


@pytest.mark.parametrize("name,steps,open_", [
    ("dycore", 1, False), ("dycore_plain", 1, False), ("dycore_overlap", 1, False),
    ("dycore_plain_open", 1, True), ("dycore_overlap_open", 1, True), ("dycore_two", 2, False),
    ("dycore_extended", 2, False)])
def test_dycore_steps_match_jax(ranks, jmesh, name, steps, open_):
    """The sharded (plain, overlapped, extended-state; periodic and open
    clamp) MiniDycore steps equal the JAX package's sharded step."""
    p = CASES[name]
    kw = dict(periodic=(False, False), boundary="clamp") if open_ else {}
    want = jax_dycore(jmesh, p["shape"], p["seed"], steps=steps, **kw)
    got = result(ranks, name)
    for n in ("u", "utens_stage"):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-12, atol=1e-12, err_msg=n)


def test_dycore_matches_single_device(ranks):
    """The sharded step equals the JAX package's single-device periodic step
    (tests/parallel/test_distributed_dycore.py's comparison)."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.dycore import MiniDycore, periodic_fill

    nk, ni, nj = CASES["dycore"]["shape"]
    state = dist_cases.dycore_state((nk, ni, nj), 0, np.float64)
    single = MiniDycore(ni, nj, nk, dtype=np.float64, backend="jax", aligned=False)
    h = MiniDycore.HALO
    buf = {}
    for k, v in state.items():
        b = np.zeros(single.field_shape())
        b[:, h:h + ni, h:h + nj] = v
        buf[k] = jnp.asarray(b)
    step = single.step_fn(fill_halos=True)
    out = jax.jit(lambda s: step({k: periodic_fill(v, h, ni, nj) for k, v in s.items()}))(buf)
    got = result(ranks, "dycore")
    for n in ("u", "utens_stage"):
        np.testing.assert_allclose(got[n], np.asarray(out[n])[:, h:h + ni, h:h + nj],
                                   rtol=1e-12, atol=1e-12, err_msg=n)


@pytest.mark.parametrize("plain,other", [("dycore_plain", "dycore_overlap"),
                                         ("dycore_plain_open", "dycore_overlap_open"),
                                         ("dycore_two", "dycore_extended")])
def test_overlapped_and_extended_equal_plain(ranks, plain, other):
    """The overlapped step (interior from the blocks before the exchange,
    strips after) and the extended-state steps equal the plain sharded
    step bit for bit."""
    a, b = result(ranks, plain), result(ranks, other)
    for n in ("u", "utens_stage"):
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_dycore_bf16_wire(ranks, jmesh):
    """A bfloat16 wire on the float64 step: equal to the JAX package's step
    with the same wire; beyond the step's reach from every rank edge equal
    bit for bit to one rank's run over the whole domain with that wire."""
    import jax.numpy as jnp

    p = CASES["dycore_wire"]
    got = result(ranks, "dycore_wire")
    want = jax_dycore(jmesh, p["shape"], p["seed"], wire=jnp.bfloat16)
    nk, ni, nj = p["shape"]
    reach = 3  # MiniDycore.HALO: one step's reach
    mask = np.zeros((ni, nj), dtype=bool)
    for bi in range(2):
        for bj in range(2):
            i0, j0 = bi * ni // 2, bj * nj // 2
            mask[i0 + reach: i0 + ni // 2 - reach, j0 + reach: j0 + nj // 2 - reach] = True
    assert mask.any()
    for n in ("u", "utens_stage"):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-12, atol=1e-12, err_msg=n)
        np.testing.assert_array_equal(got[n][:, mask], got["single"][n][:, mask], err_msg=n)
        assert not np.array_equal(got[n], got["single"][n])


def test_fv_matches_single_device(ranks):
    """The sharded FvAdvection step equals the JAX package's single-device
    periodic step (tests/parallel/test_distributed_fv.py's comparison)."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.fv_advection import FvAdvection

    nk, ni, nj = CASES["fv"]["shape"]
    st = dist_cases.fv_state((nk, ni, nj), 7, np.float64)
    single = FvAdvection(ni, nj, nk, dtype=np.float64, backend="jax", aligned=False)
    h = FvAdvection.HALO

    def embed(a):
        buf = np.zeros(single.field_shape())
        buf[:, h:h + ni, h:h + nj] = a
        return jnp.asarray(buf)

    out = jax.jit(single.step_fn())(embed(st["q"]), embed(st["cx"]), embed(st["cy"]))
    np.testing.assert_allclose(result(ranks, "fv")["q"], np.asarray(out)[:, h:h + ni, h:h + nj],
                               rtol=1e-12, atol=1e-12)


def test_shallow_water_matches_single_device(ranks):
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.shallow_water import ShallowWater

    nk, ni, nj = CASES["shallow_water"]["shape"]
    h = ShallowWater.HALO
    single = ShallowWater(ni, nj, nk, dtype=np.float64, backend="jax", aligned=False)
    st = single.init_state(seed=5)
    outs = jax.jit(single.step_fn())(*(jnp.asarray(st[k]) for k in ("h", "u", "v")))
    got = result(ranks, "shallow_water")
    for n, o in zip(("h", "u", "v"), outs):
        np.testing.assert_allclose(got[n], np.asarray(o)[:, h:h + ni, h:h + nj], rtol=1e-12,
                                   atol=1e-12, err_msg=n)


# --------------------------------------------------------------------------- #
# stencils on the mesh
# --------------------------------------------------------------------------- #


def test_global_view_laplacian(ranks):
    """A stencil's functional on DistributedFields equals the single-device
    result on the global domain (tests/parallel/test_distributed.py)."""
    inp = np.random.default_rng(0).random((32, 32, 4))
    want = np.zeros_like(inp)
    want[1:-1, 1:-1] = (-4.0 * inp[1:-1, 1:-1] + inp[2:, 1:-1] + inp[:-2, 1:-1]
                        + inp[1:-1, 2:] + inp[1:-1, :-2])
    np.testing.assert_allclose(result(ranks, "global_laplacian"), want, rtol=1e-12, atol=1e-12)


def test_shard_map_periodic_laplacian(ranks):
    inp = np.random.default_rng(1).random((16, 32, 4))
    want = (-4.0 * inp + np.roll(inp, -1, 0) + np.roll(inp, 1, 0) + np.roll(inp, -1, 1)
            + np.roll(inp, 1, 1))
    np.testing.assert_allclose(result(ranks, "shard_map_laplacian"), want, rtol=1e-12,
                               atol=1e-12)


def test_shard_map_serial_k(ranks):
    inp = np.random.default_rng(2).random((8, 16, 9))
    np.testing.assert_allclose(result(ranks, "serial_k"), np.cumsum(inp, axis=2), rtol=1e-12)


@pytest.mark.parametrize("seed", range(11000, 11006))
def test_random_program_global_view(ranks, seed):
    """The JAX package's GSPMD fuzz leg: a generated program (regions,
    while loops, variable K) on DistributedFields equals the JAX backend's
    single-device run of the same draws, every field, at 1e-12."""
    got = result(ranks, f"gspmd_{seed}")
    for name, ref in jax_single(seed).items():
        np.testing.assert_allclose(got[name], ref, rtol=1e-12, atol=1e-12, err_msg=name)


def jax_single(seed):
    """The JAX backend's single-device run of ``gspmd_program(seed)``'s
    draws: every field after the call."""
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import analysis as analysis_mod
    from gt4py_tpu.cartesian.backend import from_name
    from gt4py_tpu.testing.program_gen import ProgramGenerator
    import random

    rng = random.Random(seed)
    domain = (2 * rng.randint(2, 8), 4 * rng.randint(2, 6), rng.randint(1, 7))
    gen = ProgramGenerator(rng, dtype=np.float64)
    an = analysis_mod.analyze(gen.generate())
    _, _, pdomain, arrays, scalars = dist_cases.gspmd_program(seed)
    assert pdomain == domain
    origins = {n: (6, 6, 1) for n in arrays}
    single = from_name("jax")(an, {}).apply({k: jnp.asarray(v) for k, v in arrays.items()},
                                            scalars, domain, origins)
    return {n: np.asarray(single[n]) if n in single else arrays[n] for n in arrays}


@pytest.mark.parametrize("seed", GSPMD_MORE)
def test_random_program_global_view_or_decline(ranks, seed):
    """More generated programs on DistributedFields: each equals the same
    backend's single-device run bit for bit, the programs of
    ``GSPMD_CROSS_RANK`` (whose ranks read values a neighbouring rank
    writes during the call) also the JAX backend's at 1e-12.  A program
    that ``cross_rank_read`` names runs in phases: an exchange before each
    phase run (``LAST_GLOBAL``: as many exchanges as runs), 11238's
    BACKWARD loop one level at a time, 11203's ``while`` an iteration at a
    time; the others run from one exchange."""
    from gt4py_tpu_torch.parallel.distributed import cross_rank_read

    got = result(ranks, f"gspmd_{seed}")
    rec = got["record"]
    for name, ref in dist_cases.gspmd_single(seed).items():
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
    if seed in GSPMD_CROSS_RANK:
        for name, ref in jax_single(seed).items():
            np.testing.assert_allclose(got[name], ref, rtol=1e-12, atol=1e-12, err_msg=name)
    why = cross_rank_read(dist_cases.gspmd_stencil(seed, "torch")[0].analysis)
    assert rec["phased"] == bool(why), rec
    assert rec["exchanges"] == rec["runs"] and rec["bytes"] > 0, rec
    if not why:
        assert rec["exchanges"] == 1 and rec["phases"] == 1, rec
    if seed == 11238:
        domain = dist_cases.gspmd_program(seed)[2]
        assert rec["levels"] == domain[2] and rec["runs"] == domain[2] + 1, rec
    if seed == 11203:
        (n,) = rec["iterations"]
        assert n >= 1 and rec["runs"] == 2 + n and rec["levels"] == 0, rec


@pytest.mark.parametrize("seed", GSPMD_CROSS_RANK)
def test_declined_programs_need_the_neighbours_writes(ranks, seed):
    """The declines are needed: run across the ranks from one exchange
    anyway, each program of ``GSPMD_CROSS_RANK`` differs from its
    single-device run."""
    got = result(ranks, f"undeclined_{seed}")
    single = dist_cases.gspmd_single(seed)
    assert any(not np.array_equal(got[n], single[n], equal_nan=True) for n in single)


def test_chip_distribution_case_on_the_cpu(ranks):
    """The chip check's distribution case at a small size on CPU tensors:
    the sharded and FvAdvection steps equal the single-device ones bit for
    bit, and each rank's blocks after the bfloat16 wire's exchange are the
    float32 exchange's with every received strip cast to bfloat16 and back,
    bit for bit, at half the bytes."""
    out = result(ranks, "chip_distribution")
    for r in out["ranks"]:
        assert r["wire_blocks_equal"] and r["wire_strips_moved"] > 0, r
        assert r["wire_exchange"]["bytes"] * 2 == r["exchange"]["bytes"], r
        assert r["overlap_vs_plain"] == 0, r
    assert all(out["equal"].values()) and out["fv_equal"] and out["finite"], out
    assert out["gspmd_max_abs_err"] == {11000: 0.0}, out


def test_ring_read_declines_on_ranks(ranks):
    """The plane form's ring read (``test_torch_plane.py``'s ``ring``): a
    FORWARD loop reads ``t`` at the neighbouring point of the level before,
    where ``t``'s writer computes only the domain's points.  A rank's edge
    reads the neighbour's value of the call, so the call runs one level at
    a time with ``t`` exchanged between levels (as many exchanges as the
    domain's levels: the first before the call), and equals the
    single-device run bit for bit: on ``"torch"``, and on ``"cuda"`` with
    the generated kernels built by the host compiler (the emulated
    runtime), which every phase launched, the plain executor never."""
    if "ring_cuda" not in ranks:
        pytest.skip("needs a host C++ compiler (g++) for the emulated kernels")
    shape = (24, 36, 5)
    ref = dist_cases.ring_single(shape)
    for name in ("ring", "ring_cuda"):
        got = result(ranks, name)
        np.testing.assert_array_equal(got["c"], ref, err_msg=name)
        rec = got["record"]
        assert rec["phased"] and rec["levels"] == shape[2], rec
        assert rec["exchanges"] == shape[2] == rec["runs"], rec
    cuda = result(ranks, "ring_cuda")
    assert all(n > 0 for n in cuda["phase_launches"]), cuda
    assert sum(cuda["phase_launches"]) == shape[2], cuda
    assert cuda["library_launches"] >= shape[2], cuda


def test_gspmd_programs_have_regions():
    """The six seeds reach the region frame: their programs hold horizontal
    regions."""
    from gt4py_tpu_torch.cartesian import ir

    with_regions = [s for s in range(11000, 11006) if any(
        isinstance(x, ir.HorizontalRestriction)
        for loop in dist_cases.gspmd_program(s)[1].vertical_loops for sec in loop.sections
        for st in sec.body for x in ir.walk_values(st))]
    assert with_regions, with_regions


def test_dryrun_multirank_on_the_cpu(tmp_path):
    """The dry run's legs on four gloo ranks over CPU tensors, at a small
    size (on the card: ``chip_smoke.py --dist`` and ``dryrun_multirank``)."""
    from gt4py_tpu_torch.parallel.dryrun import dryrun_multirank

    out = dryrun_multirank(4, device="cpu", size=(4, 32, 32))
    assert out["tiny"]["u"].shape == (6, 16, 16)
    assert out["overlap"]["u"].shape == (4, 32, 32)
    assert out["next_lap"]["ranges"] == [(1, 15), (1, 31)]


@pytest.mark.parametrize("seed", range(11000, 11006))
def test_region_frame_on_the_kernels(emulated, seed):  # noqa: F811
    """The region frame on the generated kernels (built by the host
    compiler against the emulated runtime) and on the plain executor: the
    program called on each quarter of its domain, in the frame of the
    whole, gives the whole call's values there, on both backends alike."""
    import torch

    from gt4py_tpu_torch.cartesian import analysis as analysis_mod
    from gt4py_tpu_torch.cartesian.backend import from_name
    from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

    gen, stencil, domain, arrays, scalars = dist_cases.gspmd_program(seed)
    an = analysis_mod.analyze(stencil)
    objs = {b: StencilObject(analysis=an, backend=from_name(b)(an, {}), backend_name=b,
                             name=stencil.name, options={}, stencil_id=f"frame-{seed}-{b}")
            for b in ("torch", "cuda")}
    o = (6, 6, 1)

    def call(backend, origin, dom, frame=None):
        tensors = {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}
        return objs[backend]._execute(tensors, scalars, {n: origin for n in tensors}, dom,
                                      physical=False, periodic=(), validate_args=False,
                                      frame=frame)

    whole = call("torch", o, domain)
    assert objs["cuda"].backend.launches == 0
    for i0, i1 in ((0, domain[0] // 2), (domain[0] // 2, domain[0])):
        for j0, j1 in ((0, domain[1] // 2), (domain[1] // 2, domain[1])):
            origin = (o[0] + i0, o[1] + j0, o[2])
            part = (i1 - i0, j1 - j0, domain[2])
            frame = (i0, j0, domain[0], domain[1])
            outs = {b: call(b, origin, part, frame) for b in ("torch", "cuda")}
            box = (slice(o[0] + i0, o[0] + i1), slice(o[1] + j0, o[1] + j1),
                   slice(o[2], o[2] + domain[2]))
            for name, ref in whole.items():
                for b in ("torch", "cuda"):
                    np.testing.assert_allclose(outs[b][name][box].numpy(), ref[box].numpy(),
                                               rtol=1e-12, atol=1e-12, err_msg=f"{b} {name}")
    assert objs["cuda"].backend.launches == 4


def test_a_failing_rank_fails_the_launch(tmp_path):
    """With ``strict`` (as the chip check launches), a rank whose case
    raises fails the whole launch; nothing is caught."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="boundary must be"):
        dist_cases.launch({"bad": dict(case="exchange", shape=(8, 8), h=1, boundary="bogus")},
                          workdir=str(tmp_path), strict=True, timeout=30)


def test_overlap_needs_an_interior():
    """As the JAX package's: a rank interior not larger than twice the halo
    has no halo-independent interior to overlap."""
    from gt4py_tpu_torch.parallel import CartesianMesh, overlapped_shard_map_stencil

    with pytest.raises(ValueError, match="overlap needs local interior > 2\\*halo"):
        overlapped_shard_map_stencil(lambda o, d: None, CartesianMesh.single("cpu"), (3, 3),
                                     field_names=("u",), local_shape=(6, 16))


def test_extended_round_trip_and_single_rank_fields():
    """``to_extended`` / ``from_extended`` round-trip a block bit for bit;
    ``DistributedField.zeros`` / ``from_array`` on a mesh of one rank hold
    the whole array, and ``gather`` gives it back."""
    import torch

    from gt4py_tpu_torch.parallel import (CartesianMesh, DistributedField, FieldSharding,
                                          from_extended, gather, to_extended)

    mesh = CartesianMesh.single("cpu")
    a = torch.from_numpy(np.random.default_rng(0).random((3, 8, 10)))
    ext = to_extended(mesh, a, (2, 3), (1, 2))
    assert ext.shape == (3, 12, 16) and not ext[:, :2].any() and not ext[:, :, -3:].any()
    assert torch.equal(from_extended(mesh, ext, (2, 3), (1, 2)), a)
    z = DistributedField.zeros(mesh, (4, 6, 2), np.float32, origin=(1, 1, 0))
    assert z.shape == (4, 6, 2) and z.origin == (1, 1, 0) and z.index == ((0, 4), (0, 6), (0, 2))
    f = DistributedField.from_array(mesh, a.numpy(), spatial_axes=(1, 2))
    assert f.sharding == FieldSharding(mesh, (1, 2)) and f.global_shape == (3, 8, 10)
    np.testing.assert_array_equal(gather(f), a.numpy())
