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

#: the sharded MiniDycore step's gradient cases: the step's mode and
#: boundaries (``dist_cases.dycore_grad``)
GRAD_STEPS = {
    "periodic": dict(options={"derivative": "kernels"}),
    "periodic_plain_rerun": dict(),
    "zero": dict(periodic=(False, False), boundary="zero"),
    "clamp": dict(periodic=(False, False), boundary="clamp"),
    "extended": dict(mode="extended"),
    "overlap": dict(mode="overlap", periodic=(True, False), boundary="clamp"),
    "wire": dict(wire="bfloat16"),
}

#: exchanges of a block that carries a tangent: the case's parameters
EXCHANGE_JVPS = {
    "periodic": dict(shape=(8, 8), h=1, seed=4),
    "clamp": dict(shape=(12, 12), h=2, seed=3, periodic=(False, False), boundary="clamp",
                  api="func"),
    "wire": dict(shape=(16, 16), h=2, seed=5, wire="bfloat16"),
}

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
    **{f"grad_{n}": dict(case="dycore_grad", shape=DYCORE, seed=2, **kw)
       for n, kw in GRAD_STEPS.items()},
    "grad_global_region": dict(case="global_grad", which="region",
                               options={"derivative": "kernels"}),
    "grad_global_region_plain": dict(case="global_grad", which="region", backend="torch"),
    "grad_global_hdiff": dict(case="global_grad", which="hdiff", shape=(20, 24, 3),
                              options={"derivative": "kernels"}),
    "grad_phased_ring": dict(case="phased_grad", which="ring", options={"derivative": "kernels"}),
    "grad_phased_chain": dict(case="phased_grad", which="chain",
                              options={"derivative": "kernels"}),
    "grad_phased_fuzz": dict(case="phased_grad", which=11238),
    "grad_phased_while": dict(case="phased_while_grad"),
    "grad_unused": dict(case="exchange_grad_unused"),
    "dual_exchange": dict(),
    **{f"jvp_exchange_{n}": dict(case="exchange_jvp", **kw) for n, kw in EXCHANGE_JVPS.items()},
    **{f"jvp_{n}": dict(case="dycore_jvp", shape=DYCORE, seed=2, **kw)
       for n, kw in GRAD_STEPS.items()},
    **{f"func_{api}": dict(case="dycore_func", shape=DYCORE, seed=2, api=api, **kw)
       for api, kw in (("grad", {}), ("vjp", dict(options={"derivative": "kernels"})))},
    "jvp_global_region": dict(case="global_jvp", which="region",
                              options={"derivative": "kernels"}),
    "jvp_global_region_plain": dict(case="global_jvp", which="region", backend="torch"),
    "jvp_global_hdiff": dict(case="global_jvp", which="hdiff", shape=(20, 24, 3),
                             options={"derivative": "kernels"}),
    "jvp_phased_ring": dict(case="phased_jvp", which="ring", options={"derivative": "kernels"}),
    "jvp_phased_chain": dict(case="phased_jvp", which="chain",
                             options={"derivative": "kernels"}),
    "jvp_phased_fuzz": dict(case="phased_jvp", which=11238),
    "jvp_phased_while": dict(case="phased_jvp", which=11203),
    **{f"lower_dim_{w}_{o}": dict(case="phased_lower_dim", which=w, options={"derivative": o})
       for w in dist_cases.LOWER_DIM_WANTED for o in (None, "kernels")},
    **{f"scaled_{o}": dict(case="scaled_grad", options={"derivative": o})
       for o in (None, "kernels")},
    "chip_phased": dict(ring_shape=(24, 36, 5), seeds=(11238,), reps=1),
    "chip_grads": dict(shape=(4, 32, 32), reps=1),
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
    ring and the chain's gradient and tangent on the emulated kernels
    (``ring_cuda``, ``grad_phased_chain_cuda``, ``jvp_phased_chain_cuda``)."""
    from .test_torch_emulated import EMULATED_BF16, EMULATED_FP16, EMULATED_RUNTIME

    cases = dict(CASES)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is not None:
        d = tmp_path_factory.mktemp("emulated_ranks")
        for header, text in (("cuda_runtime.h", EMULATED_RUNTIME), ("cuda_fp16.h", EMULATED_FP16),
                             ("cuda_bf16.h", EMULATED_BF16)):
            (d / header).write_text(text)
        emulate = functools.partial(_emulated_kernels, cxx, str(d))
        cases["ring_cuda"] = dict(case="ring", backend="cuda", emulate=emulate)
        cases["grad_phased_chain_cuda"] = dict(case="phased_grad", which="chain",
                                               options={"derivative": "kernels"},
                                               emulate=emulate)
        cases["jvp_phased_chain_cuda"] = dict(case="phased_jvp", which="chain",
                                              options={"derivative": "kernels"},
                                              emulate=emulate)
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


def _jax_program(seed):
    """The JAX backend on the JAX package's GSPMD fuzz program of ``seed``,
    which ``gspmd_program(seed)`` draws the same."""
    import random

    from gt4py_tpu.cartesian import analysis as analysis_mod
    from gt4py_tpu.cartesian.backend import from_name
    from gt4py_tpu.testing.program_gen import ProgramGenerator

    rng = random.Random(seed)
    domain = (2 * rng.randint(2, 8), 4 * rng.randint(2, 6), rng.randint(1, 7))
    assert domain == dist_cases.gspmd_program(seed)[2]
    return from_name("jax")(analysis_mod.analyze(ProgramGenerator(
        rng, dtype=np.float64).generate()), {})


def jax_single(seed):
    """The JAX backend's single-device run of ``gspmd_program(seed)``'s
    draws: every field after the call."""
    import jax.numpy as jnp

    _, _, domain, arrays, scalars = dist_cases.gspmd_program(seed)
    origins = {n: (6, 6, 1) for n in arrays}
    single = _jax_program(seed).apply({k: jnp.asarray(v) for k, v in arrays.items()},
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


# --------------------------------------------------------------------------- #
# gradients through the exchange and the global view
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def jax_dycore_grad(periodic=(True, True), boundary="zero"):
    """``jax.grad`` of the gradient cases' loss through the JAX package's
    single-device MiniDycore step on the global arrays, each padded by the
    halo as the exchange fills it (wrapped, zero or edge)."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.dycore import MiniDycore

    nk, ni, nj = DYCORE
    h = MiniDycore.HALO
    state = dist_cases.dycore_state(DYCORE, 2, np.float64)
    weights = dist_cases.grad_weights(DYCORE, 2)
    step = MiniDycore(ni, nj, nk, dtype=np.float64, backend="jax",
                      aligned=False).step_fn(fill_halos=False)

    def pad(x):
        for ax, wrap in ((1, periodic[0]), (2, periodic[1])):
            widths = [(0, 0)] * 3
            widths[ax] = (h, h)
            x = jnp.pad(x, widths, mode="wrap" if wrap else
                        "edge" if boundary == "clamp" else "constant")
        return x

    def loss(s):
        out = step({k: pad(v) for k, v in s.items()})
        return sum(jnp.sum(out[n][:, h:h + ni, h:h + nj] * w) for n, w in weights.items())

    g = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in state.items()})
    return {k: np.asarray(v) for k, v in g.items()}


def jax_dycore_wire_grad(jmesh):
    """``jax.grad`` of the same loss through the JAX package's sharded step
    with a bfloat16 wire on the 2x2 mesh: its own rounding, transposed."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.models.dycore import MiniDycore
    from gt4py_tpu.parallel import gather, shard_map_stencil

    nk, ni, nj = DYCORE
    state = dist_cases.dycore_state(DYCORE, 2, np.float64)
    weights = dist_cases.grad_weights(DYCORE, 2)
    lstep = MiniDycore(ni // 2, nj // 2, nk, dtype=np.float64, backend="jax",
                       aligned=False).step_fn(fill_halos=False)
    h = MiniDycore.HALO
    step = shard_map_stencil(lambda **kw: lstep(dict(kw)), jmesh, (h, h),
                             field_names=tuple(state), spatial_axes=(1, 2),
                             halo_wire_dtype=jnp.bfloat16)
    sharding = NamedSharding(jmesh.mesh, P(None, "x", "y"))

    def loss(s):
        out = step(**s)
        return sum(jnp.sum(out[n] * w) for n, w in weights.items())

    g = jax.jit(jax.grad(loss))({k: jax.device_put(v, sharding) for k, v in state.items()})
    return {k: gather(v) for k, v in g.items()}


@pytest.mark.parametrize("name", sorted(GRAD_STEPS))
def test_sharded_step_gradients_match_jax(ranks, jmesh, name):
    """The gradient of the sharded MiniDycore step, every rank calling the
    backward through the transposed exchange (periodic, open with zero and
    clamp edges, extended state, the overlapped step with a periodic and a
    clamped axis, on the derivative stencils and through the plain
    re-run), assembled from the ranks, equals ``jax.grad`` of the JAX
    package's single-device step; with a bfloat16 wire, that of its
    sharded step with the same wire."""
    p = GRAD_STEPS[name]
    if name == "wire":
        want = jax_dycore_wire_grad(jmesh)
    else:
        want = jax_dycore_grad(p.get("periodic", (True, True)), p.get("boundary", "zero"))
    got = result(ranks, f"grad_{name}")
    for n, ref in want.items():
        np.testing.assert_allclose(got["grads"][n], ref, rtol=1e-12, atol=1e-12, err_msg=n)
        assert float(np.abs(ref).max()) > 0
    rec = got["transpose"]
    assert rec["backend"] == "gloo" and rec["strips"] > 0 and rec["bytes"] > 0
    if name == "wire":
        assert rec["wire_dtype"] == "bfloat16"
        exact = result(ranks, "grad_periodic")["grads"]
        assert any(not np.array_equal(got["grads"][n], exact[n]) for n in want)


#: ``dist_cases._region_stencil``'s definition, for the JAX package
REGION_MIX = """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, I, J, computation, horizontal, interval, region

F = gtscript.Field[np.float64]


def region_mix(in_f: F, w: F, out_f: F):
    with computation(PARALLEL), interval(...):
        out_f = w * (in_f[1, 0, 0] + in_f[-1, 0, 0] + in_f[0, 1, 0] * in_f[0, -1, 0]) - in_f
        with horizontal(region[I[0]: I[0] + 3, :], region[:, J[-1] - 2: J[-1]]):
            out_f = out_f * in_f + w[1, 0, 0]
"""


def _jax_twin(src, name):
    """The function ``name`` of the source ``src`` (the frontend reads it
    through linecache)."""
    import linecache

    filename = f"<test-parallel:{name}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns = {}
    exec(compile(src, filename, "exec", dont_inherit=True), ns)
    return ns[name]


def _jax_global_call(which):
    """The global derivative cases' twin on the JAX package on one device:
    the output as a function of the inputs, the inputs and the case's
    seed."""
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import gtscript as jg
    from gt4py_tpu.models.dycore import make_hdiff

    p = CASES[f"grad_global_{which}"]
    shape, seed = p.get("shape", (16, 24, 4)), p.get("seed", 3)
    _, origin, domain, arrays, out_name = dist_cases.global_grad_case(which, shape, seed,
                                                                      "torch")
    if which == "region":
        st = jg.stencil(backend="jax", definition=_jax_twin(REGION_MIX, "region_mix"),
                        rebuild=True)
    else:
        st = make_hdiff(np.float64, backend="jax")
    fn = st.functional(origin=origin, domain=domain)
    return (lambda a: fn(**a)[out_name]), {k: jnp.asarray(v) for k, v in arrays.items()}, seed


def _jax_global(which):
    """The global gradient cases' ``jax.grad`` on one device."""
    import jax
    import jax.numpy as jnp

    out, inputs, seed = _jax_global_call(which)
    w = np.random.default_rng(seed + 100).random(next(iter(inputs.values())).shape)

    def loss(a):
        return jnp.sum(out(a) * w)

    g = jax.jit(jax.grad(loss))(inputs)
    return {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("name", ["region", "region_plain", "hdiff"])
def test_global_view_gradients_match_jax(ranks, name):
    """A call on DistributedFields whose blocks require grad: the gradients
    (the call's derivative stencils in its region frame, or the plain
    executor's autograd, then the first exchange transposed), gathered,
    equal ``jax.grad`` of the JAX package's single-device call."""
    got = result(ranks, f"grad_global_{name}")
    want = _jax_global(name.split("_")[0])
    for n, ref in want.items():
        np.testing.assert_allclose(got["grads"][n], ref, rtol=1e-12, atol=1e-12, err_msg=n)
        assert float(np.abs(ref).max()) > 0
    if name != "region_plain":
        assert (got["adjoint_calls"], got["plain_reruns"]) == (1, 0)


#: the phased gradient cases' definitions (``dist_cases._ring_stencil``,
#: ``_chain_stencil``), for the JAX package
PHASED = {"ring": """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

F = gtscript.Field[np.float64]


def ring(a: F, c: F):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, -1]
            t = a * 2.0
""", "chain": """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, PARALLEL, computation, interval

F = gtscript.Field[np.float64]


def chain(a: F, c: F):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
        with interval(1, None):
            u = t[1, 0, -1]
            t = u * a + a[0, 1, 0]
    with computation(PARALLEL), interval(...):
        c = t * a
"""}


def _jax_phased_call(which):
    """A phased derivative case's call (``dist_cases.phased_grad_case``)
    on the JAX package on one device: its written fields as a function of
    its fields, and its fields."""
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import gtscript as jg

    _, origins, domain, arrays, scalars = dist_cases.phased_grad_case(which, "torch")
    if isinstance(which, str):
        fn = jg.stencil(backend="jax", definition=_jax_twin(PHASED[which], which),
                        rebuild=True).functional(origin=origins, domain=domain)

        def run(a):
            return fn(**a)
    else:
        backend = _jax_program(which)

        def run(a):
            return backend.apply(a, scalars, domain, origins)

    return run, {k: jnp.asarray(v) for k, v in arrays.items()}


def _jax_phased_loss(which):
    """The loss of a phased gradient case (``dist_cases.phased_grad``) on
    the JAX package's single-device call, and its inputs."""
    import jax.numpy as jnp

    run, inputs = _jax_phased_call(which)

    def loss(a):
        out = run(a)
        w = dist_cases.phased_grad_weights(inputs, list(out), 0)
        return sum(jnp.sum(out[n] * v) for n, v in w.items())

    return loss, inputs


PHASED_GRADS = ["ring", "chain", "fuzz", "chain_cuda"]


@pytest.mark.parametrize("name", PHASED_GRADS)
def test_phased_call_gradients_match_jax(ranks, name):
    """A phased call's gathered gradients on four ranks equal ``jax.grad``
    of the JAX package's single-device call, for every field.  With
    ``derivative="kernels"`` the backward is the adjoint stencil's own
    global-view call (on the emulated kernels for ``chain_cuda``), never a
    plain re-run: the ring's adjoint reads only the exchanged cotangent and
    runs from one exchange, the chain's steps its recomputed forward and its
    reversed loop a level at a time.  The generated program 11238 (a
    BACKWARD loop a level at a time, absolute-K reads of the fields whose
    gradient is wanted, one of ``derivative.PLAIN_RERUN``'s constructs)
    re-runs its phases on the plain executor under autograd."""
    import jax

    key = f"grad_phased_{name}"
    if key not in ranks:
        pytest.skip("needs a host C++ compiler (g++) for the emulated kernels")
    got = result(ranks, key)
    which = 11238 if name == "fuzz" else name.split("_")[0]
    loss, inputs = _jax_phased_loss(which)
    want = jax.jit(jax.grad(loss))(inputs)
    for n, ref in want.items():
        np.testing.assert_allclose(got["grads"][n], np.asarray(ref), rtol=1e-12, atol=1e-12,
                                   err_msg=n)
    assert float(np.abs(np.asarray(want["in0" if name == "fuzz" else "a"])).max()) > 0
    rec = got["record"]
    levels = dist_cases.gspmd_program(11238)[2][2] if name == "fuzz" else 5
    assert rec["phased"] and rec["levels"] == levels, rec
    adj = rec["adjoint"]
    if name == "fuzz":
        assert adj["plain"] and adj["levels"] == levels and got["plain_reruns"] == 1, got
        return
    assert (got["adjoint_calls"], got["plain_reruns"]) == (1, 0), got
    assert adj["stencil"] == f"{which}__adj", adj
    if which == "ring":
        assert not adj["phased"] and adj["exchanges"] == 1, adj
    else:
        # the recomputed forward's levels, then the reversed loop's
        assert adj["phased"] and adj["levels"] == 2 * levels, adj
        assert adj["exchanges"] == adj["runs"], adj


def test_phased_while_derivative_raises(ranks):
    """A gradient through a phased call that iterates a ``while`` across
    the ranks (the generated program 11203) raises the named error on every
    rank, as ``jax.grad`` of the JAX package's single-device call (a
    ``lax.while_loop``) raises."""
    import jax

    from gt4py_tpu_torch.parallel.distributed import PHASED_WHILE

    for status, res in ranks["grad_phased_while"]:
        assert status == "ok" and res == PHASED_WHILE
    backend = _jax_program(11203)
    _, origins, domain, arrays, scalars = dist_cases.phased_grad_case(11203, "torch")

    def loss(a):
        return sum(v.sum() for v in backend.apply({**arrays, "in0": a}, scalars, domain,
                                                  origins).values())

    with pytest.raises(ValueError, match="while_loop"):
        jax.grad(loss)(arrays["in0"])


#: ``dist_cases._lower_dim_stencil``'s definitions, for the JAX package
LOWER_DIM = {"scalar": ("ring_scalar", """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

F = gtscript.Field[np.float64]


def ring_scalar(a: F, c: F, s: float):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, -1] * s
            t = a * 2.0
"""), "ij_read": ("ring_ij_read", """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

F = gtscript.Field[np.float64]
FIJ = gtscript.Field[gtscript.IJ, np.float64]


def ring_ij_read(a: F, h: FIJ, c: F):
    with computation(FORWARD):
        with interval(0, 1):
            t = a * h
            c = t
        with interval(1, None):
            c = t[1, 0, -1]
            t = a * 2.0
"""), "ij_write": ("ring_ij_write", """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import FORWARD, computation, interval

F = gtscript.Field[np.float64]
FIJ = gtscript.Field[gtscript.IJ, np.float64]


def ring_ij_write(a: F, c: F, h: FIJ):
    with computation(FORWARD):
        with interval(0, 1):
            t = a
            c = t
        with interval(1, None):
            c = t[1, 0, -1]
            t = a * 2.0
            h = h + c
""")}


@pytest.mark.parametrize("opt", [None, "kernels"])
@pytest.mark.parametrize("which", list(LOWER_DIM))
def test_phased_lower_dim_gradients_match_jax(ranks, which, opt):
    """A phased call's gradient through a tensor scalar, an I-J field it
    reads or an I-J field it writes, on four ranks, equals ``jax.grad`` of
    the JAX package's single-device call: the fields' gathered and the
    scalar's on every rank; its tangents with tangents for the same inputs
    equal ``jax.jvp``'s.  With ``derivative="kernels"`` the adjoint
    stencil's global-view call gives it (the scalar's per-point
    contribution and the read field's split as the call's fields, each
    rank summing its own points; the written field's state and bar as I-J
    fields), with the default rule the plain re-run of the phases."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import gtscript as jg

    name, src = LOWER_DIM[which]
    arrays, scalars, domain = dist_cases.lower_dim_case(which)
    fn = jg.stencil(backend="jax", definition=_jax_twin(src, name), rebuild=True).functional(
        origin=(1, 1, 0), domain=domain)
    wanted = dist_cases.LOWER_DIM_WANTED[which]

    def loss(x):
        args = {**arrays, **scalars, **x}
        out = fn(**args)
        w = dist_cases.phased_grad_weights(arrays, list(out), 0)
        return sum(jnp.sum(out[n] * v) for n, v in w.items())

    want = jax.jit(jax.grad(loss))({n: jnp.asarray({**arrays, **scalars}[n]) for n in wanted})
    got = result(ranks, f"lower_dim_{which}_{opt}")
    for n in wanted:
        ref = np.asarray(want[n])
        assert float(np.abs(ref).max()) > 0, n
        if n in scalars:
            for _, res in ranks[f"lower_dim_{which}_{opt}"]:
                np.testing.assert_allclose(res["scalars"][n], ref, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_allclose(got["grads"][n], ref, rtol=1e-12, atol=1e-12, err_msg=n)
    adj = got["record"]["adjoint"]
    if opt == "kernels":
        assert (got["adjoint_calls"], got["plain_reruns"]) == (1, 0), got
        assert adj["stencil"] == f"{name}__adj", adj
    else:
        assert (got["adjoint_calls"], got["plain_reruns"]) == (0, 1) and adj["plain"], got
    # and forward AD with tangents for the same inputs, against jax.jvp
    rng = np.random.default_rng(200)
    primal = {n: jnp.asarray({**arrays, **scalars}[n]) for n in wanted}
    tans = {n: jnp.asarray(rng.random(np.shape(v))) for n, v in primal.items()}
    _, tout = jax.jvp(lambda x: fn(**{**arrays, **scalars, **x}), (primal,), (tans,))
    assert sorted(got["tangents"]) == sorted(tout)
    for n, ref in tout.items():
        assert float(np.abs(np.asarray(ref)).max()) > 0, n
        np.testing.assert_allclose(got["tangents"][n], np.asarray(ref), rtol=1e-12,
                                   atol=1e-12, err_msg=n)


def test_chip_phased_case_on_the_cpu(ranks):
    """The chip check's phase 15 phased calls at a small size on CPU
    tensors: the ring and the generated program 11238 equal their
    single-device runs bit for bit, and the gradients of the ring and the
    chain (here the plain re-run of their phases, on the card the adjoint
    stencil's call), the ring's tangent (the plain re-run on duals; on the
    card the tangent stencil's call) and the ring's gradients through a
    tensor scalar and an I-J field the single-device ones."""
    got = result(ranks, "chip_phased")
    assert all(s["equal"] and s["finite"] for s in got["single"].values()), got["single"]
    assert sorted(got["grads"]) == ["chain", "ij_read_grad", "ring", "ring_jvp", "scalar_grad"]
    for g in got["grads"].values():
        assert g["close"] and g["finite"] and g["largest"] > 0, g
    for r in got["ranks"]:
        for name in ("ring", "chain", "scalar", "ij_read"):
            g = r[f"{name}_grad"]
            assert g["phased"] and (g["adjoint_calls"], g["plain_reruns"]) == (0, 1), r
            assert g["adjoint"]["plain"] and g["ms"] > 0, r
        assert r["chain_grad"]["forward_ms"] > 0, r
        assert r["scalar_grad"]["scalars"]["s"] == got["ranks"][0]["scalar_grad"]["scalars"]["s"]
        j = r["ring_jvp"]
        assert j["phased"] and (j["tangent_calls"], j["plain_reruns"]) == (0, 1), r
        assert j["tangent"]["plain"] and j["ms"] > 0, r


def test_chip_grads_case_on_the_cpu(ranks):
    """The chip check's phase 15 gradient case at a small size on the CPU:
    the sharded step's and the global-view hdiff's gathered gradients and
    tangents equal the single-device ones, every rank ran the transposed
    exchanges and sent the tangents as it sent the values."""
    got = result(ranks, "chip_grads")
    for what in ("step", "global", "step_tangent", "global_tangent"):
        for n, c in got[what].items():
            assert c["close"] and c["finite"] and c["largest"] > 0, (what, n, c)
    for r in got["ranks"]:
        for key in ("step_transpose", "global_transpose", "transpose"):
            assert r[key]["backend"] == "gloo" and r[key]["bytes"] > 0, (r["rank"], key)
        assert r["transpose"]["bytes"] == r["exchange"]["bytes"]
        for key in ("step_tangent_exchange", "global_tangent_exchange"):
            assert r[key]["tangent_bytes"] == r[key]["bytes"] > 0, (r["rank"], key)
        assert r["step_jvp_ms"] > 0 and r["global_jvp_ms"] > 0 and \
            r["step_tangent_kernel_ms"] is None, r


@pytest.mark.parametrize("mode", ["circular", "constant", "replicate"])
def test_single_rank_exchange_gradient_is_the_pad_transpose(mode):
    """On a mesh of one rank the exchange fills locally (a wrap, zeros or
    the edge plane): its gradient equals autograd's through ``torch``'s
    pad of the same mode; with a bfloat16 wire the wrapped halos'
    cotangents round on their way back."""
    import torch

    from gt4py_tpu_torch.parallel import CartesianMesh, halo_exchange
    from gt4py_tpu_torch.parallel.halo import LAST_TRANSPOSE

    mesh = CartesianMesh.single("cpu")
    h = 2
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((3, 8, 10)))
    w = torch.from_numpy(rng.random((3, 8 + 2 * h, 10 + 2 * h)))
    kw = {"circular": dict(periodic=(True, True)),
          "constant": dict(periodic=(False, False)),
          "replicate": dict(periodic=(False, False), boundary="clamp")}[mode]
    leaf = a.clone().requires_grad_()
    ext = halo_exchange(torch.nn.functional.pad(leaf, (h, h, h, h)), (h, h),
                        spatial_axes=(1, 2), cmesh=mesh, **kw)
    (got,) = torch.autograd.grad((ext * w).sum(), leaf)
    ref_leaf = a.clone().requires_grad_()
    ref = torch.nn.functional.pad(ref_leaf[None], (h, h, h, h), mode=mode)[0]
    (want,) = torch.autograd.grad((ref * w).sum(), ref_leaf)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert LAST_TRANSPOSE["backend"] == "local" and LAST_TRANSPOSE["local_strips"] > 0
    if mode == "circular":
        leaf = a.clone().requires_grad_()
        ext = halo_exchange(torch.nn.functional.pad(leaf, (h, h, h, h)), (h, h),
                            spatial_axes=(1, 2), cmesh=mesh, wire_dtype=torch.bfloat16, **kw)
        (wired,) = torch.autograd.grad((ext * w).sum(), leaf)
        # the points no halo copies take the interior's cotangent alone;
        # the others differ by the rounding of their halos' cotangents
        assert torch.equal(wired[:, h:-h, h:-h], got[:, h:-h, h:-h])
        assert not torch.equal(wired, got)
        assert float((wired - got).abs().max()) < 2 ** -7 * 4 * float(w.abs().max())


def test_unused_block_takes_part_in_the_transpose(ranks):
    """A rank whose loss reads one block of an exchange still takes part
    in the transpose of every block: no rank waits, and the gradients equal
    those of the loss over both blocks with zero weights."""
    for status, res in ranks["grad_unused"]:
        assert status == "ok" and res == 0.0, res


# --------------------------------------------------------------------------- #
# forward mode and torch.func through the exchange and the global view
# --------------------------------------------------------------------------- #


def test_dual_exchange_carries_the_neighbours_tangents(ranks):
    """A block that carries a forward-mode tangent (ten times its values)
    exchanged in place: every rank's received halos carry the neighbours'
    tangents, ten times the values received, nowhere a tangent of the
    plain in-place path."""
    for status, res in ranks["dual_exchange"]:
        assert status == "ok", res
        assert res["max_diff"] == 0.0 and res["halo_max"] > 0, res


def jax_exchange_jvp(jmesh, arr, tan, h, **kw):
    """``jax.jvp`` of the JAX package's exchange of the global ``arr``
    (extended on the 2x2 mesh) at the tangent ``tan``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gt4py_tpu.parallel import halo_exchange, to_extended

    spec = P("x", "y")
    sharding = jmesh.field_sharding(arr.ndim)

    def ex(x):
        return jax.shard_map(lambda b: halo_exchange(b, (h, h), **kw), mesh=jmesh.mesh,
                             in_specs=(spec,), out_specs=spec, check_vma=False)(
            to_extended(jmesh, x, (h, h)))

    p, t = jax.jvp(ex, (jax.device_put(arr, sharding),), (jax.device_put(tan, sharding),))
    return np.asarray(p), np.asarray(t)


@pytest.mark.parametrize("name", list(EXCHANGE_JVPS))
def test_exchange_tangents_match_jax(ranks, jmesh, name):
    """The exchange of a dual block (``torch.autograd.forward_ad``, or
    ``torch.func.jvp`` for the clamped one): every rank's extended values
    and tangents equal ``jax.jvp`` of the JAX package's exchange bit for
    bit (periodic, open with clamped edges, a bfloat16 wire that rounds the
    tangent strips as it rounds the values), and the tangents' exchange
    sent as many bytes as the values'."""
    import jax.numpy as jnp

    p = EXCHANGE_JVPS[name]
    rng = np.random.default_rng(p["seed"])
    arr, tan = rng.random(p["shape"]), rng.random(p["shape"])
    kw = dict(periodic=p.get("periodic", (True, True)), boundary=p.get("boundary", "zero"))
    if "wire" in p:
        kw["wire_dtype"] = jnp.bfloat16
    want_p, want_t = jax_exchange_jvp(jmesh, arr, tan, p["h"], **kw)
    got = result(ranks, f"jvp_exchange_{name}")
    np.testing.assert_array_equal(got["primal"], want_p)
    np.testing.assert_array_equal(got["tangent"], want_t)
    rec = got["record"]
    assert rec["tangent_bytes"] == rec["bytes"] > 0 and rec["tangent_fields"] == 1, rec


@functools.lru_cache(maxsize=None)
def jax_dycore_jvp(periodic=(True, True), boundary="zero", jmesh=None):
    """``jax.jvp`` of the JAX package's MiniDycore step at the tangent
    cases' state and tangents: ``u`` and ``utens_stage``'s tangents.  On
    one device with the global arrays padded as the exchange fills them
    (``jmesh`` None), or the sharded step with a bfloat16 wire on
    ``jmesh``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.models.dycore import MiniDycore
    from gt4py_tpu.parallel import gather, shard_map_stencil

    nk, ni, nj = DYCORE
    h = MiniDycore.HALO
    state = dist_cases.dycore_state(DYCORE, 2, np.float64)
    tans = dist_cases.dycore_state(DYCORE, 202, np.float64)
    if jmesh is not None:
        lstep = MiniDycore(ni // 2, nj // 2, nk, dtype=np.float64, backend="jax",
                           aligned=False).step_fn(fill_halos=False)
        step = shard_map_stencil(lambda **kw: lstep(dict(kw)), jmesh, (h, h),
                                 field_names=tuple(state), spatial_axes=(1, 2),
                                 halo_wire_dtype=jnp.bfloat16)
        sharding = NamedSharding(jmesh.mesh, P(None, "x", "y"))

        def run(s):
            out = step(**s)
            return out["u"], out["utens_stage"]

        _, t = jax.jit(lambda s, ts: jax.jvp(run, (s,), (ts,)))(
            {k: jax.device_put(v, sharding) for k, v in state.items()},
            {k: jax.device_put(v, sharding) for k, v in tans.items()})
        return {"u": gather(t[0]), "utens_stage": gather(t[1])}
    step = MiniDycore(ni, nj, nk, dtype=np.float64, backend="jax",
                      aligned=False).step_fn(fill_halos=False)

    def pad(x):
        for ax, wrap in ((1, periodic[0]), (2, periodic[1])):
            widths = [(0, 0)] * 3
            widths[ax] = (h, h)
            x = jnp.pad(x, widths, mode="wrap" if wrap else
                        "edge" if boundary == "clamp" else "constant")
        return x

    def run(s):
        out = step({k: pad(v) for k, v in s.items()})
        return tuple(out[n][:, h:h + ni, h:h + nj] for n in ("u", "utens_stage"))

    _, t = jax.jit(lambda s, ts: jax.jvp(run, (s,), (ts,)))(
        {k: jnp.asarray(v) for k, v in state.items()}, {k: jnp.asarray(v) for k, v in tans.items()})
    return {"u": np.asarray(t[0]), "utens_stage": np.asarray(t[1])}


@pytest.mark.parametrize("name", sorted(GRAD_STEPS))
def test_sharded_step_tangents_match_jax(ranks, jmesh, name):
    """``torch.func.jvp`` of the sharded MiniDycore step (every case of
    ``GRAD_STEPS``: periodic, open with zero and clamp edges, extended
    state, the overlapped step, a bfloat16 wire, the derivative stencils
    and the plain re-run), assembled from the ranks, equals ``jax.jvp`` of
    the JAX package's single-device step (the wire's: of its sharded step
    with the same wire); each exchange's tangents travelled as its values
    did, and the kernels rule ran the tangent stencils alone."""
    p = GRAD_STEPS[name]
    if name == "wire":
        want = jax_dycore_jvp(jmesh=jmesh)
    else:
        want = jax_dycore_jvp(p.get("periodic", (True, True)), p.get("boundary", "zero"))
    got = result(ranks, f"jvp_{name}")
    for n, ref in want.items():
        assert float(np.abs(ref).max()) > 0, n
        np.testing.assert_allclose(got["tangents"][n], ref, rtol=1e-12, atol=1e-12, err_msg=n)
    rec = got["exchange"]
    assert rec["tangent_bytes"] == rec["bytes"] > 0 and rec["tangent_fields"] == 5, rec
    if p.get("options"):
        assert got["counts"]["tangent_calls"] >= 1 and got["counts"]["plain_reruns"] == 0, got


@pytest.mark.parametrize("api", ["grad", "vjp"])
def test_sharded_step_func_gradients_match_jax(ranks, api):
    """``torch.func.grad`` (the plain re-run) and ``torch.func.vjp`` (the
    adjoint stencils) through the periodic sharded step equal ``jax.grad``
    of the JAX package's single-device step."""
    got = result(ranks, f"func_{api}")
    for n, ref in jax_dycore_grad().items():
        np.testing.assert_allclose(got["grads"][n], ref, rtol=1e-12, atol=1e-12, err_msg=n)
    if api == "vjp":
        assert got["counts"]["adjoint_calls"] >= 1 and got["counts"]["plain_reruns"] == 0, got


@pytest.mark.parametrize("name", ["region", "region_plain", "hdiff"])
def test_global_view_tangents_match_jax(ranks, name):
    """Forward AD of a call on DistributedFields (the first exchange
    carrying the tangents, then the tangent stencil in the region frame or
    the plain executor on duals), gathered, equals ``jax.jvp`` of the JAX
    package's single-device call."""
    import jax
    import jax.numpy as jnp

    out, inputs, seed = _jax_global_call(name.split("_")[0])
    rng = np.random.default_rng(seed + 200)
    tans = {n: jnp.asarray(rng.random(v.shape)) for n, v in inputs.items()}
    _, want = jax.jvp(out, (inputs,), (tans,))
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 0
    got = result(ranks, f"jvp_global_{name}")
    np.testing.assert_allclose(got["tangent"], want, rtol=1e-12, atol=1e-12)
    assert got["exchange"]["tangent_bytes"] == got["exchange"]["bytes"] > 0
    if name != "region_plain":
        assert (got["tangent_calls"], got["plain_reruns"]) == (1, 0), got


@pytest.mark.parametrize("name", ["ring", "chain", "fuzz", "chain_cuda", "while"])
def test_phased_call_tangents_match_jax(ranks, name):
    """Forward AD of a phased call on four ranks, gathered, equals
    ``jax.jvp`` of the JAX package's single-device call for every written
    field.  With ``derivative="kernels"`` (the ring, the chain, and the
    chain on the emulated kernels) the tangent stencil runs as a
    global-view call of its own, phased as the call is, once and with no
    plain re-run; the generated programs 11238 (absolute-K reads) and 11203
    (a ``while`` iterated across the ranks, whose ``lax.while_loop`` has a
    jvp) re-run their phases on the plain executor on duals, their
    exchanges carrying the tangents."""
    import jax
    import jax.numpy as jnp

    key = f"jvp_phased_{name}"
    if key not in ranks:
        pytest.skip("needs a host C++ compiler (g++) for the emulated kernels")
    which = {"fuzz": 11238, "while": 11203}.get(name, name.split("_")[0])
    run, inputs = _jax_phased_call(which)
    rng = np.random.default_rng(200)
    tans = {n: jnp.asarray(rng.random(v.shape)) for n, v in inputs.items()}
    _, want = jax.jvp(run, (inputs,), (tans,))
    got = result(ranks, key)
    assert sorted(got["tangents"]) == sorted(want)
    assert any(float(np.abs(np.asarray(v)).max()) > 0 for v in want.values())
    for n, ref in want.items():
        np.testing.assert_allclose(got["tangents"][n], np.asarray(ref), rtol=1e-12,
                                   atol=1e-12, err_msg=n)
    tan = got["record"]["tangent"]
    assert got["record"]["phased"] and tan["phased"], got["record"]
    if isinstance(which, int):
        assert tan["plain"] and (got["tangent_calls"], got["plain_reruns"]) == (0, 1), got
        if which == 11203:
            assert tan["iterations"] == got["record"]["iterations"] != [], tan
        return
    assert (got["tangent_calls"], got["plain_reruns"]) == (1, 0), got
    assert tan["stencil"] == f"{which}__tan" and tan["exchanges"] == tan["runs"], tan


@pytest.mark.parametrize("opt", [None, "kernels"])
def test_replicated_scalar_derivative_rule(ranks, opt):
    """A tensor scalar of a call on DistributedFields is replicated: with a
    call that runs from one exchange, every rank's gradient of the scalar
    is ``jax.grad``'s, the ranks' partial gradients summed over the mesh
    (as the phased calls' are, ``test_phased_lower_dim_gradients_match_jax``),
    the field's gradient too; and the output's tangent, with the same
    tangent of the scalar on every rank, is ``jax.jvp``'s."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import gtscript as jg

    shape = dist_cases.SCALED_SHAPE
    rng = np.random.default_rng(5)
    a, c, w, ta = (rng.random(shape) for _ in range(4))
    fn = jg.stencil(backend="jax", definition=_jax_twin(SCALED, "scaled"), rebuild=True
                    ).functional(origin=(1, 1, 0), domain=(shape[0] - 2, shape[1] - 2, shape[2]))

    def out(x, s):
        return fn(a=x, c=jnp.asarray(c), s=s)["c"]

    ga, gs = jax.grad(lambda x, s: jnp.sum(out(x, s) * w), argnums=(0, 1))(jnp.asarray(a), 0.75)
    _, tan = jax.jvp(out, (jnp.asarray(a), 0.75), (jnp.asarray(ta), 0.5))
    got = result(ranks, f"scaled_{opt}")
    np.testing.assert_allclose(got["grad_a"], np.asarray(ga), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["tangent"], np.asarray(tan), rtol=1e-12, atol=1e-12)
    assert float(np.abs(np.asarray(tan)).max()) > 0 and float(gs) != 0
    for _, res in ranks[f"scaled_{opt}"]:
        np.testing.assert_allclose(res["grad_s"], float(gs), rtol=1e-12, atol=1e-12)


#: ``dist_cases._scaled_stencil``'s definition, for the JAX package
SCALED = """
import numpy as np
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

F = gtscript.Field[np.float64]


def scaled(a: F, c: F, s: float):
    with computation(PARALLEL), interval(...):
        c = s * (a[1, 0, 0] - a[-1, 0, 0]) + a * a[0, 1, 0] * s
"""
