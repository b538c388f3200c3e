"""The port's gather planners and the K9 butterfly, held to the JAX
package in one process.

- the host router (``csrc/benes_router.cpp``, the port's copy) gives the
  JAX package's control bits, and the packed bit-planes the kernel reads
  hold them;
- the plain butterfly (the kernel's CPU version) equals ``x[sigma]`` bit
  for bit, NaN-aliasing int32 patterns included; ineligible inputs
  decline with a recorded reason;
- sort-route and affine plans equal the JAX package's field for field on
  its meshes; the replays equal ``np.take`` and the JAX package's gathers;
- chain folding makes the same composite choice as ``_maybe_compose``,
  with a bounded cache;
- the gather fuzz (``gt4py_tpu_torch.testing.gather_fuzz``, the
  counterpart of ``gt4py_tpu/testing/gather_fuzz.py``) over 20 gather and
  20 chain seeds, with the same outcome per seed as the JAX package's.

The kernel itself runs on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gt4py_tpu.next import affine_remap as j_affine
from gt4py_tpu.next import benes as j_benes
from gt4py_tpu.next import common as j_common
from gt4py_tpu.next import sort_route as j_sort
from gt4py_tpu.next import testing as j_testing
from gt4py_tpu.testing import gather_fuzz as j_fuzz

from gt4py_tpu_torch import config
from gt4py_tpu_torch.next import affine_remap as p_affine
from gt4py_tpu_torch.next import benes as p_benes
from gt4py_tpu_torch.next import common as p_common
from gt4py_tpu_torch.next import sort_route as p_sort
from gt4py_tpu_torch.next import testing as p_testing
from gt4py_tpu_torch.testing import gather_fuzz as p_fuzz

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


#: the six NaN/Inf/sign bit patterns the JAX package's chip test moves
NAN_PATTERNS = np.array([0x7F800001, 0x7FC00000, 0x7F800000, 0xFF800000, 0x80000000,
                         0xFFFFFFFF], dtype=np.uint32)


def _perm(P, seed):
    """A random permutation ``sigma`` and its sort keys ``sigma^-1``."""
    sigma = np.random.default_rng(seed).permutation(P).astype(np.int64)
    keys = np.empty(P, dtype=np.int64)
    keys[sigma] = np.arange(P)
    return sigma, keys.astype(np.int32)


# --------------------------------------------------------------------------- #
# the router and the packed bits
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [2, 4, 256, 1 << 12, 1 << 16])
def test_router_bits_equal_the_reference(n):
    sigma, _ = _perm(n, n)
    ref = j_benes.route(sigma)
    got = p_benes.route(sigma)
    assert got.dtype == np.uint8 and got.shape == (2 * (n.bit_length() - 1) - 1, n)
    np.testing.assert_array_equal(got, ref)
    x = np.random.default_rng(1).random(n).astype(np.float32)
    np.testing.assert_array_equal(p_benes.simulate(x, got), x[sigma])


#: (n, b, c): the default layout, and small blocks that run all three passes
PACKINGS = [(2, None, None), (64, None, None), (256, None, None), (1 << 12, None, None),
            (1 << 14, None, None), (64, 3, 1), (256, 4, 2), (1 << 12, 3, 0)]


@pytest.mark.parametrize("n,b,c", PACKINGS, ids=[f"n{n}_b{b}_c{c}" for n, b, c in PACKINGS])
def test_packed_bit_planes_hold_the_router_bits(n, b, c):
    """Each CTA's bits together, each thread's bits in its own words: in
    every pass, bit s of a thread's group for a stage is the router's bit
    of the word its register s holds in that stage's layout (the pair's
    bit, which both members share); a stage on a register bit pairs two of
    a thread's registers, one on a lane bit two lanes; the passes apply
    every stage once, in order, and hold every local word once.  The
    plain version's planes: bit q of the stage at distance d is the
    router's bit of pair q's lower member."""
    sigma, _ = _perm(n, 7 * n)
    ctrl = p_benes.route(sigma)
    k = n.bit_length() - 1
    plan = p_benes.Plan(n, k, ctrl, b, c)
    assert plan.pair_bits.shape == (2 * k - 1, max(1, n // 64))
    for s, d in enumerate(p_benes.stage_distances(k)):
        lower = np.array([i for i in range(n) if not i & d])
        q = np.arange(n // 2)
        bits = (plan.pair_bits[s][q >> 5] >> (q & 31).astype(np.uint32)) & 1
        np.testing.assert_array_equal(bits, ctrl[s, lower])
    passes = p_benes._passes(k, plan.b, plan.c)
    assert [s for p in passes for s in p[2]] == list(range(2 * k - 1))
    assert plan.launches == len(passes) == (1 if plan.b == k else 3)
    for (m, cc, stages, local_bits, ncta), off in zip(passes, plan.offsets):
        assert off % 4 == 0
        G = p_benes._local_to_global(m, cc, plan.b, ncta)
        assert sorted(G.reshape(-1)) == list(range(n))
        lb, e, T = p_benes._thread_shape(m)
        E = 1 << e
        layouts, ops = p_benes._program(m, local_bits)
        assert [len(rb) for rb in layouts] == [e] * len(layouts)
        nw = (len(stages) * E + 31) // 32
        words = plan.bits[off: off + ncta * nw * T].reshape(ncta, nw, T)
        addr, valid = p_benes._addresses(m, layouts[0])
        assert sorted(addr[valid].reshape(-1)) == list(range(1 << m))
        t = 0
        for kind, arg in ops:
            if kind == 2:
                addr, valid = p_benes._addresses(m, layouts[arg])
                assert sorted(addr[valid].reshape(-1)) == list(range(1 << m))
                continue
            s, p = stages[t], local_bits[t]
            assert kind == (1 if p < lb else 0)
            if kind == 0:
                assert layouts_bit(layouts, ops, t) == p
            d = p_benes.stage_distances(k)[s]
            grp = (words[:, (t * E) >> 5, :] >> np.uint32((t * E) & 31))
            bits = (grp[:, :, None] >> np.arange(E, dtype=np.uint32)) & 1
            L = addr[valid]
            np.testing.assert_array_equal(bits[:, valid], ctrl[s][G[:, L]])
            np.testing.assert_array_equal(ctrl[s][G[:, L]], ctrl[s][G[:, L ^ (1 << p)]])
            np.testing.assert_array_equal(G[:, L ^ (1 << p)], G[:, L] ^ d)
            t += 1


def layouts_bit(layouts, ops, t):
    """The local bit of the t-th stage of a program on a register bit."""
    cur, n = layouts[0], 0
    for kind, arg in ops:
        if kind == 2:
            cur = layouts[arg]
        elif n == t:
            return cur[arg] if kind == 0 else arg
        else:
            n += 1
    raise IndexError(t)


# --------------------------------------------------------------------------- #
# the plain butterfly
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("P", [2, 256, 1 << 17, (1 << 17) + 311])
def test_plain_butterfly_bitwise_float32(P):
    sigma, keys = _perm(P, P)
    x = torch.from_numpy(np.random.default_rng(P).random(P).astype(np.float32))
    got = p_benes.permute(x, keys)
    assert got.dtype == torch.float32
    assert torch.equal(got, x[torch.from_numpy(sigma)])


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
@pytest.mark.parametrize("P", [256, 1 << 17, (1 << 17) + 311])
def test_plain_butterfly_bitwise_int_patterns(P, dtype):
    """32-bit words move as words: NaN payloads, infinities and signed
    zeros survive exactly."""
    sigma, keys = _perm(P, P + 1)
    xi = np.random.default_rng(P).integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    xi[:6] = NAN_PATTERNS
    x = torch.from_numpy(xi.view(dtype))
    got = p_benes.permute(x, keys)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.numpy(), xi.view(dtype)[sigma])


DECLINES = {
    "float64": (lambda: torch.zeros(256, dtype=torch.float64), "dtype"),
    "bfloat16": (lambda: torch.zeros(256, dtype=torch.bfloat16), "dtype"),
    "int64": (lambda: torch.zeros(256, dtype=torch.int64), "dtype"),
    "2-D": (lambda: torch.zeros((16, 16), dtype=torch.float32), "ndim"),
}


@pytest.mark.parametrize("name", list(DECLINES))
def test_ineligible_inputs_decline_with_a_reason(name):
    make, reason = DECLINES[name]
    vals = make()
    cursor = p_benes.DECLINES.cursor()
    assert p_benes.permute(vals, np.arange(vals.numel(), dtype=np.int32)) is None
    assert [r for r, _ in p_benes.DECLINES.since(cursor)] == [reason]


def test_oversize_declines_with_a_reason():
    """A padded size above 2^24 declines before any routing."""
    P = (1 << 24) + 1
    cursor = p_benes.DECLINES.cursor()
    keys = np.zeros(P, dtype=np.int32)
    assert p_benes.permute(torch.zeros(P, dtype=torch.float32), keys) is None
    assert p_benes.DECLINES.since(cursor) == [("size", P)]


def test_declined_round_takes_the_index_path():
    """``sort_route._permute`` on a dtype the network declines gathers
    ``vals[sigma]`` instead (the JAX package sorts by key: the same
    values)."""
    plan = p_sort.build_gather_plan(np.random.default_rng(0).integers(0, 70000, 70000), None)
    vals = torch.from_numpy(np.random.default_rng(1).random(plan.P))
    cursor = p_benes.DECLINES.cursor()
    got = p_sort._permute(vals, plan, 0)
    assert p_benes.DECLINES.since(cursor) == [("dtype", "torch.float64")]
    sigma = np.argsort(plan.keys[0], kind="stable")
    np.testing.assert_array_equal(got.numpy(), vals.numpy()[sigma])


def test_plan_cache_is_bounded():
    for seed in range(p_benes._PLAN_CACHE_MAX + 3):
        p_benes._plan(_perm(8, seed)[1])
    assert len(p_benes._plan_cache) <= p_benes._PLAN_CACHE_MAX


#: (k, b, c): all three passes (b < k) at k = 4..12, one pass at k = b and
#: at k < b (the block clamps to the size); inner blocks with register bits
#: and re-layouts; the default layouts (None) above one pass.  The passes'
#: sizes give 1 to 16 registers a thread (``_thread_shape``)
K9_EMULATED = [(k, b, c) for k in range(1, 13) for b, c in ((3, 1), (4, 2))] + [
    (12, 9, 3), (13, 10, 0), (12, None, None), (13, None, None),
    (14, None, None), (13, 11, 3), (14, 12, 4), (11, 8, 2)]


def test_k9_emulated_cases_reach_every_register_count():
    """The emulated cases' passes hold 1, 2, 4, 8 and 16 registers a
    thread, every instantiation of ``benes_pass``."""
    regs = set()
    for k, b, c in K9_EMULATED:
        bb = min(b if b is not None else p_benes.layout(k)[0], k)
        cc = min(c if c is not None else p_benes.layout(k)[1], bb)
        for m, *_ in p_benes._passes(k, bb, cc):
            regs.add(1 << p_benes._thread_shape(m)[1])
    assert regs == {1, 2, 4, 8, 16}, regs


@pytest.mark.parametrize("k,b,c", K9_EMULATED,
                         ids=[f"k{k}_b{b}_c{c}" for k, b, c in K9_EMULATED])
def test_k9_emulated_bitwise(emulated, monkeypatch, k, b, c):  # noqa: F811
    """``csrc/benes.cu`` built by the host compiler against the emulated
    runtime (``tests/test_torch_emulated.py``), small blocks so that every
    pass runs: the kernel's result equals ``simulate``, the plain version
    and ``x[sigma]`` bit for bit, float32 and int32 words with the
    NaN-aliasing patterns, P not a power of two at odd k; the inverse
    plan (the backward's launch) brings the words back.  One wrapper
    launch per permute, and ``Plan.launches`` kernel launches counted by
    the library."""
    monkeypatch.setattr(p_benes.KERNEL, "_lib", None)
    n2 = 1 << k
    P = n2 if k % 2 == 0 or k == 1 else n2 - 1 - k // 3
    sigma, keys = _perm(P, 31 * k + (b or 0))
    plan = p_benes._route_plan(sigma, b, c)
    if b is None:
        b, c = p_benes.layout(k)
    assert (plan.b, plan.c) == (min(b, k), min(c, b, k))
    assert plan.launches == (1 if k <= b else 3)
    padded = np.concatenate([sigma, np.arange(P, n2)])
    ctrl = p_benes.route(padded)
    rng = np.random.default_rng(k)
    xi = rng.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    xi[:min(P, 6)] = NAN_PATTERNS[:min(P, 6)]
    xf = rng.random(P).astype(np.float32)
    p_benes.KERNEL.build()
    for x in (torch.from_numpy(xf).view(torch.int32), torch.from_numpy(xi.view(np.int32))):
        before = p_benes.KERNEL.launches, p_benes.KERNEL.device_launches
        got = p_benes.KERNEL._launch(x, plan)
        # counted where the library launches the kernel
        assert p_benes.KERNEL.launches == before[0] + 1
        assert p_benes.KERNEL.device_launches == before[1] + plan.launches
        words = x.numpy()
        np.testing.assert_array_equal(got.numpy(), words[sigma])
        sim = p_benes.simulate(np.concatenate([words, np.zeros(n2 - P, np.int32)]), ctrl)
        np.testing.assert_array_equal(got.numpy(), sim[:P])
        plain = torch.zeros(n2, dtype=torch.int32)
        plain[:P] = x
        p_benes.plain_inplace(plain, plan)
        assert torch.equal(got, plain[:P])
        inverse = p_benes._inverse_plan(plan, keys)
        assert (inverse.b, inverse.c) == (plan.b, plan.c)
        assert torch.equal(p_benes.KERNEL._launch(got, inverse), x)


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    """The K9 wrapper takes contiguous int32 words of the plan's size on
    a CUDA device and raises on anything else (never a CPU fallback)."""
    plan = p_benes._plan(_perm(256, 3)[1])
    with pytest.raises(ValueError, match="CUDA"):
        p_benes.KERNEL.launch(torch.zeros(256, dtype=torch.int32), plan)


# --------------------------------------------------------------------------- #
# plans, field for field
# --------------------------------------------------------------------------- #

MESHES = {"grid": lambda m: m.grid_mesh(192), "shuffled": lambda m: m.shuffled_mesh(192, 7)}


def _tables(mesh):
    """The FVM step's gather tables: both E2V columns and V2E."""
    e2v = np.asarray(mesh.e2v.table)
    return {"e2v0": e2v[:, 0], "e2v1": e2v[:, 1], "v2e": np.asarray(mesh.v2e.table),
            "e2v": e2v}


def _skip(name, mesh):
    return mesh.v2e.skip_value if name == "v2e" else mesh.e2v.skip_value


def _norm(x):
    """A package-independent form of a plan: dataclasses as tuples of their
    compared fields, arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, _norm(getattr(x, f.name))) for f in dataclasses.fields(x)
                     if f.compare)
    if isinstance(x, (tuple, list)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return x


def _assert_same_dataclass(got, ref):
    assert (got is None) == (ref is None)
    assert _norm(got) == _norm(ref)


def test_meshes_equal_the_reference():
    for make in MESHES.values():
        pm, jm = make(p_testing), make(j_testing)
        assert (pm.n_vertices, pm.n_edges) == (jm.n_vertices, jm.n_edges)
        for name, t in _tables(pm).items():
            np.testing.assert_array_equal(t, _tables(jm)[name], err_msg=name)
    pm, jm = p_testing.SimpleMesh.make(), j_testing.SimpleMesh.make()
    np.testing.assert_array_equal(pm.v2e.table, np.asarray(jm.v2e.table))
    np.testing.assert_array_equal(pm.e2v.table, np.asarray(jm.e2v.table))
    case, _ = p_testing.simple_mesh_case()
    assert set(case.offset_provider) == {"V2E", "E2V"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("table", ["e2v0", "e2v1", "v2e"])
def test_sort_route_plans_equal_the_reference(mesh, table):
    m = MESHES[mesh](p_testing)
    t = _tables(m)[table]
    got = p_sort.build_gather_plan(t, _skip(table, m))
    ref = j_sort.build_gather_plan(t, _skip(table, m))
    _assert_same_dataclass(got, ref)
    if mesh == "shuffled":
        assert got is not None  # irregular: routed


@pytest.mark.parametrize("table", ["e2v0", "e2v1", "v2e", "e2v"])
def test_affine_plans_equal_the_reference(table):
    m = MESHES["grid"](p_testing)
    t = _tables(m)[table]
    t2 = t[:, None] if t.ndim == 1 else t
    got = p_affine.build_table_plan(t2, _skip(table, m))
    ref = j_affine.build_table_plan(t2, _skip(table, m))
    assert got is not None
    _assert_same_dataclass(got, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_gathers_equal_take_and_the_reference(mesh, dtype):
    """Each planned gather of the FVM step's tables, on an edge or vertex
    field with a trailing K axis, equals ``np.take`` of the clipped table
    and the JAX package's replay of its own plan."""
    m = MESHES[mesh](p_testing)
    rng = np.random.default_rng(4)
    for name, t in _tables(m).items():
        if name == "e2v":
            continue
        n_src = m.n_vertices if name.startswith("e2v") else m.n_edges
        data = (rng.random((n_src, 3)) * 1000).astype(dtype)
        ref = np.take(data, np.clip(t.reshape(-1), 0, n_src - 1), axis=0)
        if mesh == "grid":
            t2 = t[:, None] if t.ndim == 1 else t
            plan = p_affine.build_table_plan(t2, _skip(name, m))
            got = p_affine.apply_table_plan(plan, torch.from_numpy(data), 0, 0)
            jref = j_affine.apply_table_plan(j_affine.build_table_plan(t2, _skip(name, m)),
                                             jnp.asarray(data), 0, 0)
        else:
            plan = p_sort.build_gather_plan(t, _skip(name, m))
            got = p_sort.apply_gather_plan(plan, torch.from_numpy(data), 0, 0)
            jref = j_sort.apply_gather_plan(j_sort.build_gather_plan(t, _skip(name, m)),
                                            jnp.asarray(data), 0, 0)
        got = got.reshape(ref.shape).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(jref).reshape(ref.shape), err_msg=name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_remap_dispatch(mesh, monkeypatch):
    """``Field.remap`` of a tensor field through an E2V column: the affine
    window on the grid mesh, the sort-routed gather (its permutations
    through ``benes.permute``) on the shuffled one; the same values as the
    index path and as the JAX package's remap."""
    pm, jm = MESHES[mesh](p_testing), MESHES[mesh](j_testing)
    psi = np.random.default_rng(3).random(pm.n_vertices).astype(np.float32)
    calls = []
    real = p_benes.permute
    monkeypatch.setattr(p_benes, "permute", lambda v, k: calls.append(1) or real(v, k))
    pf = p_common.Field(p_common.Domain((p_testing.Vertex,), (p_common.UnitRange(0, len(psi)),)),
                        torch.from_numpy(psi))
    jf = j_common.Field(j_common.Domain((j_testing.Vertex,),
                                        (j_common.UnitRange(0, len(psi)),)), jnp.asarray(psi))
    pc, jc = p_common._column_conn(pm.e2v, 1), j_common._column_conn(jm.e2v, 1)
    got = pf.remap(pc).data
    assert (p_affine.plan_for(pc) is not None) == (mesh == "grid")
    assert p_sort.plan_for(pc) is not None  # consulted only where no window fits
    assert bool(calls) == (mesh == "shuffled")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.remap(jc).data))
    monkeypatch.setattr(config, "AFFINE_GATHER", False)
    monkeypatch.setattr(config, "SORT_GATHER", False)
    assert torch.equal(pf.remap(pc).data, got)


# --------------------------------------------------------------------------- #
# chains
# --------------------------------------------------------------------------- #


def _chain_conns(C, t1, t2, local):
    A, B, Cd = C.Dimension("ChA"), C.Dimension("ChB"), C.Dimension("ChC")
    L = C.Dimension("ChL", kind=C.DimensionKind.LOCAL)
    c1 = C.Connectivity(t1, source=B, codomain=A, local_dim=L if local else None,
                        skip_value=None)
    c2 = C.Connectivity(t2, source=Cd, codomain=B, skip_value=None)
    return A, c1, c2


@pytest.mark.parametrize("kind", ["affine_affine", "irregular_affine", "affine_irregular",
                                  "neighbor_table"])
def test_chain_fold_as_the_reference(kind):
    """``premap(c1, c2)`` folds into one composite exactly when the JAX
    package's ``_maybe_compose`` does, and equals the sequential gathers."""
    rng = np.random.default_rng(len(kind))
    n0, n1, n2 = 9000, 8000, 7000
    aff = lambda n, m, s: (np.arange(n, dtype=np.int64) * s) % m  # noqa: E731
    irr = lambda n, m: rng.integers(0, m, n).astype(np.int64)  # noqa: E731
    t1, t2 = {
        "affine_affine": (aff(n1, n0, 2), aff(n2, n1, 1)),
        "irregular_affine": (irr(n1, n0), aff(n2, n1, 3)),
        "affine_irregular": (aff(n1, n0, 1), irr(n2, n1)),
        "neighbor_table": (np.stack([aff(n1, n0, 1), irr(n1, n0)], axis=1), irr(n2, n1)),
    }[kind]
    data = rng.random(n0).astype(np.float32)
    out = {}
    for C, wrap in ((p_common, torch.from_numpy), (j_common, jnp.asarray)):
        A, c1, c2 = _chain_conns(C, t1, t2, t1.ndim == 2)
        f = C.Field(C.Domain((A,), (C.UnitRange(0, n0),)), wrap(data))
        comp = C._maybe_compose(c1, c2)
        one = f.premap(c1, c2)
        seq = f.remap(c1).remap(c2)
        np.testing.assert_array_equal(np.asarray(one.data), np.asarray(seq.data))
        out[C] = (comp is not None, np.asarray(one.data))
    assert out[p_common][0] == out[j_common][0]
    np.testing.assert_array_equal(out[p_common][1], out[j_common][1])


def test_compose_cache_is_bounded():
    """The composites cached on a second hop stay at most
    ``_COMPOSE_CACHE_MAX`` (the JAX package's cache grows with every
    first hop)."""
    rng = np.random.default_rng(9)
    A, B = p_common.Dimension("ChA"), p_common.Dimension("ChB")
    c2 = p_common.Connectivity(rng.integers(0, 500, 400).astype(np.int64),
                               source=p_common.Dimension("ChC"), codomain=B, skip_value=None)
    for _ in range(p_common._COMPOSE_CACHE_MAX + 5):
        c1 = p_common.Connectivity(rng.integers(0, 300, 500).astype(np.int64), source=B,
                                   codomain=A, skip_value=None)
        p_common._maybe_compose(c1, c2)
    assert len(c2.__dict__["_compose_cache"]) <= p_common._COMPOSE_CACHE_MAX


# --------------------------------------------------------------------------- #
# the gather fuzz
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(20))
def test_gather_fuzz(seed):
    outcome, launches = p_fuzz.run_gather_case(seed, device="cpu")
    assert outcome == j_fuzz.run_gather_case(seed)
    assert launches == 0  # the plain butterfly on the CPU


@pytest.mark.parametrize("seed", range(20))
def test_chain_fuzz(seed):
    outcome, launches = p_fuzz.run_chain_case(seed, device="cpu")
    assert outcome == j_fuzz.run_chain_case(seed)
    assert launches == 0
