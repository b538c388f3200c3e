"""Model-state checkpoint / resume, in the JAX package's on-disk format.

Counterpart of ``gt4py_tpu.utils.checkpoint``; the files cross between
the packages both ways.  ``save_checkpoint`` / ``load_checkpoint`` write
and read one ``.npz`` of whole arrays.  A sharded checkpoint is a
directory of ``.npy`` files, one per stored block, and one
``manifest.p<rank>.json`` per process, written LAST (crash consistency: a directory without every
process's manifest is incomplete).  Each rank stores its own blocks: a
``parallel.DistributedField``'s block, a ``next.distributed`` sharded
Field's block.  Arrays that are not distributed are the same on every
rank and are written by rank 0 only.  Extension dtypes (bfloat16, the
float8s) are stored as same-width unsigned views with the dtype's name in
the manifest; they come back as torch tensors of that dtype, without
``ml_dtypes``.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gt4py_tpu_torch.storage import FieldStorage

#: extension dtypes numpy lacks: stored as uint views, tagged by name
_EXTENSION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_EXTENSION_NAMES = {v: k for k, v in _EXTENSION_DTYPES.items()}
_UINT = {1: torch.uint8, 2: torch.int16}


def _host_view(value) -> Tuple[np.ndarray, str]:
    """(storable numpy array, dtype name): a tensor is copied to the host
    now; extension dtypes ride as uint views."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype in _EXTENSION_NAMES:
            size = t.element_size()
            raw = t.contiguous().view(_UINT[size]).cpu().numpy().view(f"u{size}")
            return raw, _EXTENSION_NAMES[t.dtype]
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(value)
    return arr, arr.dtype.name


def _from_stored(arr: np.ndarray, name: str):
    """A loaded array in its dtype: numpy, or a CPU tensor for an
    extension dtype."""
    if name in _EXTENSION_DTYPES:
        size = arr.dtype.itemsize
        raw = torch.from_numpy(arr.view(np.int16 if size == 2 else np.uint8).copy())
        return raw.view(_EXTENSION_DTYPES[name])
    return arr


def save_checkpoint(path: str, state: Dict[str, Any], *, step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write a state dict (name -> array or tensor) plus metadata as one
    ``.npz`` (the JAX package's single-file format); atomic rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays, ext = {}, {}
    for k, v in state.items():
        arrays[k], name = _host_view(v.data if isinstance(v, FieldStorage) else v)
        if name in _EXTENSION_DTYPES:
            ext[k] = name
    meta = {"step": int(step), "keys": sorted(arrays), **(metadata or {})}
    if ext:
        meta["__ext_dtypes__"] = ext
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                 **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read back ``(state, metadata)``; extension dtypes as CPU tensors."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        state = {k: data[k] for k in data.files if k != "__meta__"}
    for k, name in meta.pop("__ext_dtypes__", {}).items():
        state[k] = _from_stored(state[k], name)
    return state, meta


def restore_to_device(state: Dict[str, Any], sharding=None, device=None) -> Dict[str, Any]:
    """Loaded arrays back on ``device`` (default: the card) as tensors, or
    with ``sharding`` (a ``CartesianMesh`` or ``parallel.FieldSharding``)
    as this rank's ``DistributedField`` blocks."""
    if sharding is not None:
        from gt4py_tpu_torch.parallel.distributed import distribute

        return {k: distribute(sharding, v) for k, v in state.items()}
    from gt4py_tpu_torch import config

    dev = config.resolve_device(device)
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(dev)
            for k, v in state.items()}


def _block(value):
    """(global shape, index, block) of this rank's block of a distributed
    value, else None."""
    from gt4py_tpu_torch.parallel.distributed import DistributedField

    if isinstance(value, DistributedField):
        return value.global_shape, value.index, value.data
    index = getattr(value, "block_index", None)
    if index is not None:  # a next.distributed sharded Field
        return value.global_shape, index, value.data
    return None


def _rank() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointHandle:
    """Async save handle: ``wait()`` blocks until this rank's files and its
    manifest are durably in place."""

    def __init__(self, future):
        self._future = future

    def wait(self) -> str:
        return self._future.result()

    result = wait


def save_checkpoint_sharded(directory: str, state: Dict[str, Any], *, step: int = 0,
                            metadata: Optional[Dict[str, Any]] = None, wait: bool = True):
    """Write this rank's part of ``state`` (see the module docstring): every
    rank calls it with its own blocks, on a directory all of them share.
    The device-to-host copies happen before returning, so the caller may go
    on changing ``state``; with ``wait=False`` the file IO runs on a thread
    and the returned ``CheckpointHandle`` must be waited on."""
    rank, count = _rank()
    os.makedirs(directory, exist_ok=True)
    manifest: Dict[str, Any] = {"step": int(step), "metadata": metadata or {},
                                "process_index": rank, "process_count": count, "arrays": {}}
    to_write = []
    for name, value in state.items():
        if "/" in name or "\\" in name:
            raise ValueError(f"checkpoint key '{name}' must not contain path separators")
        entry: Dict[str, Any] = {"shards": {}}
        placed = _block(value)
        if placed is not None:
            shape, index, block = placed
            stored, entry["dtype"] = _host_view(block)
            entry["shape"] = list(shape)
            fname = f"{name}.d{rank}.npy"
            entry["shards"][str(rank)] = {"file": fname, "index": [list(i) for i in index]}
            to_write.append((os.path.join(directory, fname), stored))
        else:
            data = value.data if hasattr(value, "data") and not isinstance(
                value, (torch.Tensor, np.ndarray)) else value
            stored, dtname = _host_view(data)
            entry["shape"] = list(stored.shape)
            entry["dtype"] = dtname
            fname = f"{name}.full.npy"
            entry["shards"]["full"] = {"file": fname, "index": [[0, s] for s in stored.shape]}
            # the same on every rank: one writer, or concurrent writers race
            if rank == 0:
                to_write.append((os.path.join(directory, fname), stored))
        manifest["arrays"][name] = entry
    mpath = os.path.join(directory, f"manifest.p{rank}.json")

    def finalize() -> str:
        # overwriting: drop our manifest FIRST, so a crash mid-rewrite
        # leaves the directory visibly incomplete
        try:
            os.remove(mpath)
        except FileNotFoundError:
            pass
        for path, data in to_write:
            tmp = f"{path}.tmp.p{rank}"
            with open(tmp, "wb") as f:
                np.save(f, data)
            os.replace(tmp, path)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, mpath)
        return directory

    if wait:
        return finalize()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(finalize)
    pool.shutdown(wait=False)
    return CheckpointHandle(fut)


def is_checkpoint_complete(directory: str) -> bool:
    """True when every participating process's manifest is present."""
    manifests = sorted(glob.glob(os.path.join(directory, "manifest.p*.json")))
    if not manifests:
        return False
    try:
        with open(manifests[0]) as f:
            expected = int(json.load(f).get("process_count", 1))
    except (OSError, ValueError):
        return False
    return len(manifests) >= expected


def load_checkpoint_sharded(directory: str, *, shardings: Optional[Dict[str, Any]] = None
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reassemble the arrays from every process's files and return
    ``(state, metadata)``.  ``shardings`` (name -> ``CartesianMesh`` or
    ``parallel.FieldSharding``) re-shards those arrays onto a mesh, as
    ``DistributedField``s; the others come back whole (numpy, or a CPU
    tensor for an extension dtype).  Raises if a process's manifest is
    missing or a block of an array is absent."""
    manifests = sorted(glob.glob(os.path.join(directory, "manifest.p*.json")))
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifest in {directory}")
    arrays: Dict[str, np.ndarray] = {}
    dtnames: Dict[str, str] = {}
    covered: Dict[str, int] = {}
    meta: Dict[str, Any] = {}
    for mpath in manifests:
        with open(mpath) as f:
            m = json.load(f)
        meta = {"step": m["step"], **m["metadata"]}
        pc = int(m.get("process_count", 1))
        if len(manifests) < pc:
            raise FileNotFoundError(f"incomplete checkpoint in {directory}: "
                                    f"{len(manifests)} of {pc} process manifests present")
        for name, entry in m["arrays"].items():
            dtnames[name] = entry["dtype"]
            out = arrays.get(name)
            if out is None:
                if entry["dtype"] in _EXTENSION_DTYPES:
                    size = _EXTENSION_DTYPES[entry["dtype"]].itemsize
                    stored_dt = np.dtype(f"u{size}")
                else:
                    stored_dt = np.dtype(entry["dtype"])
                out = arrays[name] = np.zeros(entry["shape"], dtype=stored_dt)
                covered[name] = 0
            for key, shard in entry["shards"].items():
                if key == "full" and covered[name] >= out.size:
                    continue  # every process lists the one full file
                data = np.load(os.path.join(directory, shard["file"]))
                out[tuple(slice(a, b) for a, b in shard["index"])] = data
                covered[name] += int(data.size)
    for name, arr in arrays.items():
        if covered[name] < arr.size:
            raise ValueError(f"checkpoint array '{name}' in {directory} is only "
                             f"{covered[name]}/{arr.size} elements covered by shards")
    state: Dict[str, Any] = {}
    for name, arr in arrays.items():
        value = _from_stored(arr, dtnames[name])
        if shardings and name in shardings:
            from gt4py_tpu_torch.parallel.distributed import distribute

            value = distribute(shardings[name], value)
        state[name] = value
    return state, meta
