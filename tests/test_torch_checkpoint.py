"""Sharded checkpoints, resilient step loops and the grid IO of the port,
across packages: checkpoints the port's four gloo ranks write load in the
JAX package, the JAX package's load on the ranks (re-sharded), bfloat16
included, bit for bit; grid files cross both ways."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.testing import dist_cases


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def state_arrays(seed=21):
    """The global values of ``dist_cases.checkpoint_state``, bfloat16 ones
    as float32 (exact)."""
    rng = np.random.default_rng(seed)
    u = rng.random((8, 12, 3))
    b = rng.random((3, 8, 12)).astype(np.float32)
    t = rng.random((5,))
    nf = rng.random((8, 12))
    bf = torch.from_numpy(b).to(torch.bfloat16).float().numpy()
    return {"u": u, "b": bf, "nf": nf, "t": t, "bt": bf[0, 0]}


def jax_save(directory):
    """The JAX package's sharded save of the same state on a 2x2 mesh."""
    import jax
    import ml_dtypes
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.parallel import CartesianMesh
    from gt4py_tpu.utils.checkpoint import save_checkpoint_sharded

    jmesh = CartesianMesh((2, 2))
    s = state_arrays()
    bf = s["b"].astype(ml_dtypes.bfloat16)
    state = {
        "u": jax.device_put(s["u"], NamedSharding(jmesh.mesh, P("x", "y", None))),
        "b": jax.device_put(bf, NamedSharding(jmesh.mesh, P(None, "x", "y"))),
        "nf": jax.device_put(s["nf"], NamedSharding(jmesh.mesh, P("x", "y"))),
        "t": s["t"],
        "bt": bf[0, 0],
    }
    save_checkpoint_sharded(directory, state, step=5, metadata={"note": "jax"})


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def ranks(work):
    jax_save(os.path.join(work, "from_jax"))
    cases = {
        "save": dict(case="ckpt_save", directory=os.path.join(work, "from_port")),
        "save_async": dict(case="ckpt_save", directory=os.path.join(work, "async"), wait=False),
        "load_jax": dict(case="ckpt_load", directory=os.path.join(work, "from_jax")),
        "load_port": dict(case="ckpt_load", directory=os.path.join(work, "from_port")),
        "reshard": dict(case="ckpt_load", directory=os.path.join(work, "from_port"),
                        reshard=(4, 1)),
        "resilient": dict(directory=os.path.join(work, "run")),
    }
    return dist_cases.launch(cases, workdir=os.path.join(work, "ranks"))


def result(ranks, name, rank=0):
    for status, res in ranks[name]:
        assert status == "ok", res
    return ranks[name][rank][1]


def _check_state(got, meta_step, note):
    want = state_arrays()
    assert got["meta"]["step"] == meta_step and got["meta"]["note"] == note
    st = got["state"]
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(st[k], dtype=np.float64),
                                      np.asarray(v, dtype=np.float64), err_msg=k)
    assert st["__types__"]["u"] == "DistributedField"
    assert st["__dtypes__"]["b"] == "torch.bfloat16" and st["__dtypes__"]["bt"] == "torch.bfloat16"


def test_port_checkpoint_loads_in_jax(ranks, work):
    """Each rank wrote its own blocks and manifest; replicated arrays once
    (rank 0); the JAX package's loader reassembles them, bfloat16 as its
    ml_dtypes type."""
    import ml_dtypes

    from gt4py_tpu.utils.checkpoint import is_checkpoint_complete, load_checkpoint_sharded

    directory = os.path.join(work, "from_port")
    assert all(result(ranks, "save", r)["complete"] for r in range(4))
    assert is_checkpoint_complete(directory)
    files = sorted(os.listdir(directory))
    assert [f for f in files if f.startswith("manifest")] == [
        f"manifest.p{r}.json" for r in range(4)]
    assert [f for f in files if f.startswith("u.")] == [f"u.d{r}.npy" for r in range(4)]
    assert [f for f in files if f.startswith("t.")] == ["t.full.npy"]
    state, meta = load_checkpoint_sharded(directory)
    assert meta == {"step": 7, "note": "port"}
    for k, v in state_arrays().items():
        np.testing.assert_array_equal(np.asarray(state[k]).astype(np.float64), v, err_msg=k)
    assert state["b"].dtype == np.dtype(ml_dtypes.bfloat16)


def test_jax_checkpoint_loads_on_the_ranks(ranks):
    """A checkpoint the JAX package wrote (one process, four devices) loads
    on the ranks, ``u`` re-sharded onto the 2x2 mesh as a DistributedField."""
    got = result(ranks, "load_jax")
    _check_state(got, 5, "jax")
    assert got["state"]["__u_block__"] == (4, 6, 3)


def test_port_checkpoint_reshards(ranks):
    """The port's checkpoint loads back on its own mesh, and re-sharded onto
    a 4x1 mesh."""
    _check_state(result(ranks, "load_port"), 7, "port")
    got = result(ranks, "reshard")
    _check_state(got, 7, "port")
    assert got["state"]["__u_block__"] == (2, 12, 3)


def test_async_save(ranks, work):
    """``wait=False``: the handle's ``wait`` returns the directory; complete
    on every rank after the barrier."""
    for r in range(4):
        got = result(ranks, "save_async", r)
        assert got["complete"] and got["returned"] == os.path.join(work, "async")


def test_run_resilient_rolls_back_and_resumes(ranks):
    """A transient ``DistNetworkError`` at step 3 rolls back to the step-2
    checkpoint and the run ends equal to a clean run; a fresh call resumes
    from the last complete checkpoint (step 5) and runs the rest."""
    got = result(ranks, "resilient")
    np.testing.assert_array_equal(got["a"], got["clean"])
    steps_run, restarts, checkpoints, failures = got["report"]
    assert restarts == 1 and failures == 1 and steps_run == 6 and checkpoints == 3
    assert got["resumed_from"] == 5 and got["resumed_steps"] == 2 and got["n"] == 7
    assert not np.array_equal(got["resumed"], got["a"])


def test_is_transient_error():
    import torch.distributed as dist

    from gt4py_tpu_torch.utils.resilience import is_transient_error

    assert is_transient_error(dist.DistNetworkError("reset"))
    assert is_transient_error(dist.DistBackendError("nccl"))
    assert is_transient_error(dist.DistStoreError("timeout"))
    assert not is_transient_error(RuntimeError("UNAVAILABLE"))
    assert not is_transient_error(ValueError("x"))


def _single_process_save(directory):
    from gt4py_tpu_torch.utils.checkpoint import save_checkpoint_sharded

    save_checkpoint_sharded(directory, {"a": np.arange(6.0),
                                        "b": torch.ones(3, dtype=torch.bfloat16)}, step=2)


def test_incomplete_checkpoint_rejected(tmp_path):
    """A directory missing a process's manifest is incomplete and refused."""
    from gt4py_tpu_torch.utils.checkpoint import is_checkpoint_complete, load_checkpoint_sharded

    d = str(tmp_path / "c")
    _single_process_save(d)
    assert is_checkpoint_complete(d)
    m = json.load(open(os.path.join(d, "manifest.p0.json")))
    m["process_count"] = 2
    json.dump(m, open(os.path.join(d, "manifest.p0.json"), "w"))
    assert not is_checkpoint_complete(d)
    with pytest.raises(FileNotFoundError, match="1 of 2"):
        load_checkpoint_sharded(d)
    shutil.rmtree(d)
    os.makedirs(d)
    assert not is_checkpoint_complete(d)
    with pytest.raises(FileNotFoundError, match="no checkpoint manifest"):
        load_checkpoint_sharded(d)


def test_partial_shard_cover_rejected(ranks, work, tmp_path):
    """A manifest whose blocks do not cover an array raises."""
    from gt4py_tpu_torch.utils.checkpoint import load_checkpoint_sharded

    d = str(tmp_path / "partial")
    shutil.copytree(os.path.join(work, "from_port"), d)
    for r in range(4):
        p = os.path.join(d, f"manifest.p{r}.json")
        m = json.load(open(p))
        if r == 3:
            m["arrays"]["u"]["shards"] = {}
        m["process_count"] = 4
        json.dump(m, open(p, "w"))
    with pytest.raises(ValueError, match="'u'.*covered"):
        load_checkpoint_sharded(d)


def test_key_with_path_separator_rejected(tmp_path):
    from gt4py_tpu_torch.utils.checkpoint import save_checkpoint_sharded

    with pytest.raises(ValueError, match="path separators"):
        save_checkpoint_sharded(str(tmp_path / "k"), {"a/b": np.zeros(2)})


def test_single_process_roundtrip_bf16_without_ml_dtypes(tmp_path):
    from gt4py_tpu_torch.utils.checkpoint import load_checkpoint_sharded

    d = str(tmp_path / "s")
    _single_process_save(d)
    state, meta = load_checkpoint_sharded(d)
    assert meta["step"] == 2
    np.testing.assert_array_equal(state["a"], np.arange(6.0))
    assert state["b"].dtype == torch.bfloat16
    assert torch.equal(state["b"], torch.ones(3, dtype=torch.bfloat16))


def test_initialize_multihost_without_environment(monkeypatch):
    """No ``MASTER_ADDR``/``RANK``/``WORLD_SIZE``: a no-op, and the mesh is
    this process alone."""
    import torch.distributed as dist

    from gt4py_tpu_torch.parallel import CartesianMesh, initialize_multihost

    for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()
    mesh = CartesianMesh.initialize_multihost(device="cpu")
    assert mesh.shape == (1, 1) and mesh.rank == 0 and not mesh.distributed
    assert mesh.backend == "gloo" and mesh.device.type == "cpu"


def test_mesh_refuses_nccl_on_the_cpu_and_shared_cards(monkeypatch):
    from gt4py_tpu_torch.parallel.mesh import choose_backend

    with pytest.raises(ValueError, match="CUDA tensors only"):
        choose_backend(torch.device("cpu"), "nccl", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Duplicate GPU detected"):
        choose_backend(torch.device("cuda", 0), None, 4)
    assert choose_backend(torch.device("cuda", 0), "gloo", 4) == "gloo"
    assert choose_backend(torch.device("cuda", 0), None, 1) == "nccl"


# --------------------------------------------------------------------------- #
# grid IO
# --------------------------------------------------------------------------- #


@pytest.fixture
def gridio(tmp_path, monkeypatch):
    import gt4py_tpu_torch.io as gio

    monkeypatch.setattr(config, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(gio, "_lib", None)
    return gio


@pytest.fixture
def jax_gridio(tmp_path, monkeypatch):
    from gt4py_tpu import config as jconfig
    import gt4py_tpu.io as jio

    monkeypatch.setattr(jconfig, "CACHE_ROOT", str(tmp_path / "jcache"))
    monkeypatch.setattr(jio, "_lib", None)
    monkeypatch.setattr(jio, "_build_failed", False)
    return jio


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
def test_grid_files_cross_packages(gridio, jax_gridio, tmp_path, dtype):
    """A file the port writes (native and plain writers: the same bytes)
    reads in the JAX package, and the reverse, bit for bit."""
    arr = (np.random.default_rng(0).random((5, 6, 7)) * 100).astype(dtype)
    p_native, p_plain, p_jax = (str(tmp_path / f"{n}.gtg") for n in ("n", "p", "j"))
    gridio.save_grid(p_native, arr)
    gridio.save_grid_plain(p_plain, torch.from_numpy(arr))
    jax_gridio.save_grid(p_jax, arr)
    assert jax_gridio._lib is not None
    raw = open(p_native, "rb").read()
    assert raw == open(p_plain, "rb").read() == open(p_jax, "rb").read()
    for p in (p_native, p_plain, p_jax):
        np.testing.assert_array_equal(gridio.load_grid(p), arr)
        np.testing.assert_array_equal(gridio.load_grid_plain(p), arr)
        np.testing.assert_array_equal(jax_gridio.load_grid(p), arr)
        assert gridio.probe_grid(p) == (np.dtype(dtype), (5, 6, 7))


def test_grid_large_parallel_copy(gridio, tmp_path):
    arr = np.arange(40 * 1024 * 1024 // 8, dtype=np.int64).reshape(-1, 1024)
    p = str(tmp_path / "big.gtg")
    gridio.save_grid(p, arr)
    np.testing.assert_array_equal(gridio.load_grid(p), arr)


def test_grid_corrupt_header_rejected(gridio, tmp_path):
    p = str(tmp_path / "junk.gtg")
    with open(p, "wb") as f:
        f.write(b"not a grid record at all........")
    with pytest.raises(OSError):
        gridio.probe_grid(p)
    with pytest.raises(OSError):
        gridio.load_grid_plain(p)


def test_grid_build_failure_raises(gridio, monkeypatch, tmp_path):
    """No silent fallback: a failed g++ build raises ``BuildError``."""
    monkeypatch.setattr(gridio, "_CSRC", str(tmp_path / "nowhere"))
    os.makedirs(str(tmp_path / "nowhere"))
    with open(str(tmp_path / "nowhere" / "gridio.cpp"), "w") as f:
        f.write("this is not C++\n")
    with pytest.raises(gridio.BuildError):
        gridio.save_grid(str(tmp_path / "x.gtg"), np.zeros(3))


def test_checkpoint_with_gridio(gridio, tmp_path):
    """Grid IO carries a state's large arrays beside a checkpoint."""
    u = np.random.default_rng(1).random((4, 8, 8))
    p = str(tmp_path / "state_u.gtg")
    gridio.save_grid(p, torch.from_numpy(u))
    np.testing.assert_array_equal(gridio.load_grid(p), u)


def test_single_file_checkpoint_crosses_packages(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint``: the JAX package's ``.npz``
    format both ways, bfloat16 as a torch tensor here and an ml_dtypes
    array there; ``restore_to_device`` puts them on the asked device."""
    import ml_dtypes

    from gt4py_tpu.utils.checkpoint import load_checkpoint as jax_load
    from gt4py_tpu.utils.checkpoint import save_checkpoint as jax_save
    from gt4py_tpu_torch.utils.checkpoint import (load_checkpoint, restore_to_device,
                                                  save_checkpoint)

    a = np.random.default_rng(3).random((4, 5))
    b = torch.from_numpy(np.random.default_rng(4).random(6).astype(np.float32)).to(
        torch.bfloat16)
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, {"a": a, "b": b}, step=3, metadata={"k": 1})
    state, meta = jax_load(p)
    assert meta["step"] == 3 and meta["k"] == 1
    np.testing.assert_array_equal(state["a"], a)
    assert state["b"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(state["b"].astype(np.float32), b.float().numpy())
    q = str(tmp_path / "jax.npz")
    jax_save(q, {"a": a, "b": b.float().numpy().astype(ml_dtypes.bfloat16)}, step=4)
    state, meta = load_checkpoint(q)
    assert meta["step"] == 4
    np.testing.assert_array_equal(state["a"], a)
    assert state["b"].dtype == torch.bfloat16 and torch.equal(state["b"], b)
    on = restore_to_device(state, device="cpu")
    assert on["a"].device.type == "cpu" and torch.equal(on["b"], b)
