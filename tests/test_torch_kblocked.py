"""K4: deep-K serial loops K-blocked on the emulated kernels.

The cases of ``tests/cartesian/test_kblocked.py`` at their shapes (dK 512,
600, 2000 and 2048, and the dK 16 control): the ``"cuda"`` backend runs
each column-form loop as one launch in which every thread sweeps its
column block by block, the blocks' windows of read-only inputs in a ring
of shared-memory slots (``cp.async``, synchronous copies on the emulated
runtime), the carries crossing blocks in the scratch buffers.  The
kernels are built by the host compiler against the emulated runtime of
``tests/test_torch_emulated.py`` and held to the JAX package's numpy
oracle at rtol 1e-12 (float64), and bit for bit to the one-pass column
form (``k_blocked=False``) and to K4's plain counterpart
(``testing.plain_kblocked``: ``passes.clip_stencil_to_k_block`` block by
block through the plain executor).  The ring's corners (a depth below and
equal to one slot, more blocks than slots, a ragged last block, a K halo
across slots, FORWARD and BACKWARD, bounded and periodic I/J) and its
16-byte copies have cases of their own.  ``cuda_backend.LAST_PLAN``
records the passes, KB, slots, shared bytes, CTAs per SM and promoted
temporaries, or the one-pass plan and its reason; the headline stencils'
plans at 512x512x80 stay as they were.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.cartesian.backend import cuda_backend

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port

F = jgts.Field[np.float64]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def tridiag(inf: F, diag: F, sup: F, rhs: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def two_pass(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            tmp = a
        with interval(1, None):
            tmp = tmp[0, 0, -1] * 0.5 + a
    with computation(BACKWARD):
        with interval(-1, None):
            out = tmp
        with interval(0, -1):
            out = tmp + 0.25 * out[0, 0, 1]


def with_k(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a * K
        with interval(1, None):
            out = out[0, 0, -1] + a * K


def cumsum(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, None):
            out = out[0, 0, -1] + a


def staged(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, 700):
            out = out[0, 0, -1] + a
        with interval(700, -3):
            out = out[0, 0, -1] + 2.0 * a
        with interval(-3, None):
            out = out[0, 0, -1] - a


def back(a: F, out: F):
    with computation(BACKWARD):
        with interval(-1, None):
            out = a
        with interval(0, -1):
            out = 0.5 * out[0, 0, 1] + a


def two_stmt(inp: F, out: F):
    with computation(PARALLEL):
        with interval(0, -1):
            tmp = inp * 2.0
        with interval(0, -1):
            out = tmp[0, 0, 1]


def _ranges(shape, seed, lo=0.0, hi=1.0):
    return lo + (hi - lo) * np.random.default_rng(seed).random(shape)


#: name -> (definition, inputs, origin, domain, passes, promoted)
CASES = {
    "tridiagonal_dk512": (tridiag, lambda: dict(
        inf=_ranges((12, 12, 512), 1, -0.3, 0.0), diag=_ranges((12, 12, 512), 2, 2.0, 3.0),
        sup=_ranges((12, 12, 512), 3, -0.3, 0.0), rhs=_ranges((12, 12, 512), 4),
        out=np.zeros((12, 12, 512))), (2, 2, 0), (8, 8, 512), 2, []),
    "promoted_cross_loop": (two_pass, lambda: dict(
        a=_ranges((10, 10, 512), 7), out=np.zeros((10, 10, 512))),
        (0, 0, 0), (10, 10, 512), 2, ["tmp"]),
    "axis_position_dk600": (with_k, lambda: dict(
        a=_ranges((9, 9, 600), 11), out=np.zeros((9, 9, 600))), (0, 0, 0), (9, 9, 600), 1, []),
    "ragged_dk2000": (cumsum, lambda: dict(
        a=_ranges((8, 8, 2000), 13), out=np.zeros((8, 8, 2000))),
        (0, 0, 0), (8, 8, 2000), 1, []),
    "sections_dk2048": (staged, lambda: dict(
        a=_ranges((8, 8, 2048), 17), out=np.zeros((8, 8, 2048))),
        (0, 0, 0), (8, 8, 2048), 1, []),
    "backward_dk2048": (back, lambda: dict(
        a=_ranges((8, 8, 2048), 19), out=np.zeros((8, 8, 2048))),
        (0, 0, 0), (8, 8, 2048), 1, []),
}


def _run(defn, arrays, origin, domain, k_blocked=True, periodic=(), **options):
    st = pgts.stencil(backend="cuda", definition=to_port(defn), rebuild=True,
                      k_blocked=k_blocked, **options)
    out = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    st(**out, origin=origin, domain=domain, periodic=periodic)
    return st, out


@pytest.mark.parametrize("name", list(CASES))
def test_kblocked_emulated_vs_oracle(emulated, name):  # noqa: F811
    defn, make, origin, domain, n_passes, promoted = CASES[name]
    arrays = make()
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=defn, rebuild=True)(**ref, origin=origin,
                                                                 domain=domain)
    st, got = _run(defn, arrays, origin, domain)
    plan = cuda_backend.LAST_PLAN[defn.__name__]
    kb = plan["kblocked"]
    assert kb and kb["passes"] == n_passes and kb["promoted"] == promoted, plan
    # every column loop blocks the deep column: its window fits one CTA
    assert len(kb["KB"]) == sum(k.window is not None for k in st.backend.program.kernels) and all(
        8 <= k < domain[2] for k in kb["KB"]), plan
    _, one_pass = _run(defn, arrays, origin, domain, k_blocked=False)
    assert not cuda_backend.LAST_PLAN[defn.__name__]["kblocked"]
    plain = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    testing.plain_kblocked(st, plain, {}, origin, domain)
    for k in arrays:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-12, atol=0, err_msg=k)
        assert torch.equal(got[k], one_pass[k]), k
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 8, 2000)], ids=["dk16", "dk2000"])
def test_one_pass_is_the_default(emulated, shape):  # noqa: F811
    """Without ``k_blocked`` a serial stencil runs the one-pass column
    form below ``KB_DEFAULT_DEPTH`` levels (the plan says why) and K4 from
    there on, on few columns (the plan says that the default chose it);
    ``k_blocked=True``
    blocks at any depth (the dK 16 control is one block of 16, dK 2000
    blocks of 32) and ``k_blocked=False`` never."""
    arrays = dict(a=_ranges(shape, 23), out=np.zeros(shape))
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=cumsum, rebuild=True)(**ref, origin=(0, 0, 0),
                                                                   domain=shape)
    deep = shape[2] >= cuda_backend.KB_DEFAULT_DEPTH
    for k_blocked in (None, True, False):
        st, got = _run(cumsum, arrays, (0, 0, 0), shape, k_blocked=k_blocked)
        plan = cuda_backend.LAST_PLAN["cumsum"]
        if k_blocked is False or (k_blocked is None and not deep):
            assert not plan["kblocked"]
            assert plan["declined"]["kblocked"] == (
                "k_blocked=False" if k_blocked is False else
                "one pass, the default (k_blocked=True blocks)")
        else:
            # one float64 input of 2 x 32 columns, 512 bytes a level: two
            # slots of 32 levels leave 4 CTAs on a SM
            assert plan["kblocked"]["KB"] == [min(shape[2], 32)]
            assert plan["kblocked"]["reason"] == (
                "k_blocked=True" if k_blocked else
                "the default at a depth of 512 levels or more on at most 65536 columns")
            assert "kblocked" not in plan["declined"]
        # the K4 kernel is built unless k_blocked=False
        assert st.backend.source.count("__global__") == (1 if k_blocked is False else 2)
        np.testing.assert_allclose(got["out"].numpy(), ref["out"], rtol=1e-12, atol=0)


@pytest.mark.parametrize("columns,dK,default", [
    (8 * 8, 511, False), (8 * 8, 512, True), (256 * 256, 2048, True),
    (256 * 256 + 1, 2048, False), (512 * 512, 512, False), (512 * 512, 80, False)])
def test_default_gates_on_depth_and_columns(columns, dK, default):
    """The default runs K4 from ``KB_DEFAULT_DEPTH`` levels on at most
    ``KB_DEFAULT_COLUMNS`` columns (where one pass has too few threads to
    fill the card), one pass elsewhere; ``k_blocked=True`` blocks, and
    ``k_blocked=False`` keeps one pass, whatever the domain."""
    assert cuda_backend.kb_default(columns, dK) is default
    for k_blocked in (None, True, False):
        st = pgts.stencil(backend="cuda", definition=to_port(cumsum), rebuild=True,
                          k_blocked=k_blocked)
        kbs, declined = st.backend.program.kblock_plan(columns, dK)
        runs = default if k_blocked is None else k_blocked
        assert (kbs is not None) is runs, (k_blocked, kbs, declined)
        if k_blocked is None and not default:
            assert declined == cuda_backend.KB_DEFAULT_ONE_PASS


def test_parallel_cross_statement_k_dependency_declines(emulated):  # noqa: F811
    """An all-PARALLEL stencil at dK 512 (the JAX test's K-offset read of
    a sibling statement's output): no column loop, so one pass, recorded,
    and equal to the oracle."""
    arrays = dict(inp=_ranges((12, 12, 512), 29), out=np.zeros((12, 12, 512)))
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=two_stmt, rebuild=True)(
        **ref, origin=(0, 0, 0), domain=(12, 12, 512))
    _, got = _run(two_stmt, arrays, (0, 0, 0), (12, 12, 512))
    plan = cuda_backend.LAST_PLAN["two_stmt"]
    assert not plan["kblocked"] and plan["declined"]["kblocked"] == "no loop in the column form"
    np.testing.assert_allclose(got["out"].numpy(), ref["out"], rtol=1e-12, atol=0)


def test_variable_k_declines_as_the_jax_package():
    """Variable K reads of a field the stencil writes and runtime interval
    bounds keep the one-pass form even with ``k_blocked=True`` (the JAX
    package's eligibility), and the plan names the reason; a variable K
    read of a field the stencil only reads runs K4, from device memory."""
    P = pgts.Field[np.float64]

    def shift(inp: P, idx: pgts.Field[np.int64], out: P):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, idx] + out[0, 0, idx]

    def shift_read_only(inp: P, idx: pgts.Field[np.int64], out: P):
        with computation(FORWARD), interval(...):
            out = inp[0, 0, idx]

    def runtime(a: P, out: P, *, kmid: int):
        with computation(FORWARD):
            with interval(0, kmid):
                out = a
            with interval(kmid, None):
                out = out[0, 0, -1] + a

    pgts.stencil(backend="cuda", definition=shift, rebuild=True, k_blocked=True)
    assert cuda_backend.LAST_PLAN["shift"]["declined"]["kblocked"] == \
        "a variable or absolute K access of a field the stencil writes"
    st = pgts.stencil(backend="cuda", definition=shift_read_only, rebuild=True,
                      k_blocked=True)
    assert "kblocked" not in cuda_backend.LAST_PLAN["shift_read_only"]["declined"]
    assert any(k.window is not None for k in st.backend.program.kernels)
    st = pgts.stencil(backend="cuda", definition=runtime, rebuild=True, k_blocked=True)
    assert cuda_backend.LAST_PLAN["runtime"]["declined"]["kblocked"] == \
        "a runtime interval bound"
    assert all(k.window is None for k in st.backend.program.kernels)


def test_window_kernel_source():
    """One launch per column loop: the window kernel takes the block size,
    sweeps the blocks itself through a ring of two slots, stages the
    read-only inputs with cp.async and reads them from shared memory; the
    carry stays in device memory."""
    st = pgts.stencil(backend="cuda", definition=to_port(tridiag), rebuild=True, k_blocked=True)
    src = st.backend.source
    # the two column loops' K4 variants and the fused kernel of one pass
    assert src.count("__global__") == 3
    assert "gt::KBounds<4> kb_all,\n    int KB) {" in src
    assert "w_diag[((k + 0 - kb0) * 2 + (ti + 0)) * 32 + (tj + 0)]" in src
    assert "f_sup.at(i + 0, j + 0, k + -1)" in src  # written: read from device memory
    assert src.count("gt::async_copy<16>") == 4 and src.count("gt::async_wait<1>();") == 2
    # one launch of each K4 kernel, none in a loop over blocks
    for p in st.backend.program.kernels:
        assert src.count(f"{p.name}_kb<<<") == (p.window is not None)
    assert "for (int b_ = 0; b_ < nb; ++b_)" not in src
    windows = [k.window for k in st.backend.program.kernels if k.window]
    # the backward loop stages the forward loop's outputs, which it only reads
    assert [sorted(a[0] for a in w.arrays) for w in windows] == [["diag", "inf"],
                                                                 ["rhs", "sup"]]
    # two float64 inputs of 2 x 32 columns, 1 KiB a level: two slots of 16
    # levels (32 KiB) leave 4 CTAs on a SM, 32 would leave one
    assert [w.choose_kb(2048) for w in windows] == [16, 16]
    assert [w.slots for w in windows] == [2, 2] and windows[0].smem_bytes(16) == 32768
    assert windows[0].choose_kb(100) == 16 and windows[0].choose_kb(12) == 12


def ring(w: F, u: F, out: F, back: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = u[0, 0, 1] * (w[1, 0, 0] + w[0, -1, 0])
        with interval(1, -1):
            out = 0.5 * out[0, 0, -1] + u[0, 0, -1] - u[0, 0, 1] * w[-1, 0, 0] + w[0, 1, 0]
        with interval(-1, None):
            out = 0.5 * out[0, 0, -1] + u[0, 0, -1]
    with computation(BACKWARD):
        with interval(-1, None):
            back = out + u
        with interval(0, -1):
            back = 0.25 * back[0, 0, 1] + out * u[0, 0, 1] + w[1, 1, 0]


#: name -> (dK, KB): the ring's corners
RING = {
    "dk_below_one_slot": (10, 16),
    "dk_equals_one_slot": (16, 16),
    "more_blocks_than_slots_ragged": (45, 8),
    "k_halo_across_slots": (24, 8),
}


def _ring_arrays(dK, dtype):
    dI, dJ = 9, 13
    # periodic: the oracle fills the halos in place, the port wraps the reads
    shape, origin = (dI + 2, dJ + 2, dK), (1, 1, 0)
    arrays = dict(w=_ranges(shape, 41, -1.0, 1.0), u=_ranges(shape, 43),
                  out=np.zeros(shape), back=np.zeros(shape))
    return {k: v.astype(dtype) for k, v in arrays.items()}, origin, (dI, dJ, dK)


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
@pytest.mark.parametrize("name", list(RING))
def test_ring_emulated_vs_oracle_and_one_pass(emulated, monkeypatch, name, periodic):  # noqa: F811
    """K4's ring on the emulated kernels at its corners -- the depth below
    and equal to one slot, more blocks than slots with a ragged last one,
    ``u``'s K halo (levels -1 and +1) across the slots' boundaries --
    FORWARD and BACKWARD (the backward loop stages the forward one's
    ``out``), reads at I/J offsets bounded and periodic: equal to the JAX
    package's numpy oracle at rtol 1e-12, and bit for bit to the one-pass
    column form and to K4's plain counterpart; one launch per loop."""
    dK, KB = RING[name]
    monkeypatch.setattr(cuda_backend.WindowPlan, "choose_kb", lambda self, dk: KB)
    arrays, origin, domain = _ring_arrays(dK, np.float64)
    ref = {k: v.copy() for k, v in arrays.items()}
    jgts.stencil(backend="numpy", definition=ring, rebuild=True)(
        **ref, origin=origin, domain=domain, periodic=periodic)
    st, got = _run(ring, arrays, origin, domain, periodic=periodic)
    kb = cuda_backend.LAST_PLAN["ring"]["kblocked"]
    assert kb["KB"] == [KB, KB] and kb["slots"] == [2, 2] and kb["launches_per_loop"] == [1, 1]
    assert st.backend.launches == 1
    _, one_pass = _run(ring, arrays, origin, domain, k_blocked=False, periodic=periodic)
    plain = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    testing.plain_kblocked(st, plain, {}, origin, domain, periodic=periodic)
    for k in ("out", "back"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-12, atol=0, err_msg=k)
        assert torch.equal(got[k], one_pass[k]), k
        assert torch.equal(got[k], plain[k]), k


F32 = jgts.Field[np.float32]


def ring32(w: F32, u: F32, out: F32, back: F32):
    with computation(FORWARD):
        with interval(0, 1):
            out = u[0, 0, 1] * (w[1, 0, 0] + w[0, -1, 0])
        with interval(1, -1):
            out = 0.5 * out[0, 0, -1] + u[0, 0, -1] - u[0, 0, 1] * w[-1, 0, 0] + w[0, 1, 0]
        with interval(-1, None):
            out = 0.5 * out[0, 0, -1] + u[0, 0, -1]
    with computation(BACKWARD):
        with interval(-1, None):
            back = out + u
        with interval(0, -1):
            back = 0.25 * back[0, 0, 1] + out * u[0, 0, 1] + w[1, 1, 0]


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["bounded", "periodic"])
def test_ring_float32_sixteen_byte_copies(emulated, periodic):  # noqa: F811
    """float32 windows on J-contiguous buffers whose rows start on 16
    bytes (the models' layout): ``u``'s rows are copied as 16-byte words,
    ``w``'s (read at J - 1, so its window starts one element before a
    word), the periodic seam and the ragged row end element by element; a
    misaligned 16-byte copy would fault the emulated launch.  Bit for bit
    equal to the one-pass column form and to K4's plain counterpart."""
    arrays, origin, domain = _ring_arrays(40, np.float32)
    # physical (K, I, J) buffers, J padded to 24 (rows of 96 bytes), the
    # domain's J origin at element 4
    dI, dJ, dK = domain
    phys = {}
    for k, v in arrays.items():
        buf = np.zeros((dK, dI + 2, 24), np.float32)
        buf[:, :, 3:3 + dJ + 2] = v.transpose(2, 0, 1)
        phys[k] = buf
    origin = (1, 4, 0)
    got, copies = {}, {}
    for k_blocked in (True, False):
        st = pgts.stencil(backend="cuda", definition=to_port(ring32), rebuild=True,
                          k_blocked=k_blocked)
        out = {k: torch.from_numpy(v.copy()) for k, v in phys.items()}
        # one counter in the process (the emulated runtime's inline variable)
        count = st.backend.build().gt_emu_copies16_count
        before = count()
        st(**{k: v.permute(1, 2, 0) for k, v in out.items()}, origin=origin, domain=domain,
           periodic=periodic)
        got[k_blocked] = out
        copies[k_blocked] = count() - before
        if k_blocked:
            # the forward loop stages w and u, the backward one out, u and w
            assert [k.window.lanes for k in st.backend.program.kernels if k.window] == [
                [4, 4], [4, 4, 4]]
            plain = {k: torch.from_numpy(v.copy()) for k, v in phys.items()}
            testing.plain_kblocked(st, {k: v.permute(1, 2, 0) for k, v in plain.items()}, {},
                                   origin, domain, periodic=periodic)
    assert copies[True] > 0 and copies[False] == 0
    for k in ("out", "back"):
        assert torch.equal(got[True][k], got[False][k]), k
        assert torch.equal(got[True][k], plain[k]), k


def test_plan_records_one_launch_per_loop(emulated):  # noqa: F811
    """``LAST_PLAN[name]["kblocked"]`` after a K4 launch: one launch per
    column loop (the K4 launches the library counted in that call), KB,
    the ring's slots and shared bytes per loop, and the CTAs a SM holds
    (the occupancy query; the emulated runtime applies the H100's
    shared-memory rule).  A second call counts its own launches."""
    defn, make, origin, domain, n_passes, promoted = CASES["tridiagonal_dk512"]
    before = None
    for _ in range(2):
        st, _ = _run(defn, make(), origin, domain)
        kb = cuda_backend.LAST_PLAN["tridiag"]["kblocked"]
        assert kb == {"reason": "k_blocked=True", "passes": 2, "KB": [16, 16],
                      "slots": [2, 2], "smem_bytes": [32768, 32768], "ctas_per_sm": [6, 6],
                      "promoted": [], "launches_per_loop": [1, 1]}, kb
        # the library's counts (shared by the builds of one source): every
        # launch, and the K4 ones by kernel
        counts = st.backend.device_launches()
        if before is not None:
            # the fused kernel (index 2) has no K4 variant
            assert [a - b for a, b in zip(counts["kblocked"], before["kblocked"])] == [1, 1, 0]
            assert counts["all"] - before["all"] == 2, (counts, before)
        before = counts
    assert min(kb["ctas_per_sm"]) >= cuda_backend.KB_CTAS_PER_SM


#: ``LAST_PLAN`` of the headline stencils at 512x512x80 float32, the same
#: at build and at depth 80: hdiff and fv_step one tile kernel each, the
#: column loops one fused kernel (K4's window kernels beside it); the fused
#: step split by default (``cuda_backend.SERIALIZE_MIXED``), no sweep
HEADLINE_PLANS = {
    "dycore_fused_float32": {
        "columns": [{"carries": ["datacol"],
                     "columns": ["ccol", "dcol"],
                     "kernel": "dycore_fused_float32_k3_col",
                     "loops": 2,
                     "prefetch": 26}],
        "declined": {"kblocked": "one pass, the default (k_blocked=True blocks)",
                     "serialize": cuda_backend.SPLIT_MIXED},
        "forms": ["tile", "column"],
        "kblocked": False,
        "registers": ["acol", "as_", "bcol", "correction_term", "cs", "divided", "gav", "gcv",
                      "res"],
        "scratch": ["u_stage", "ccol", "dcol", "datacol"],
        "serialized": False,
        "shared": ["flx_field", "fly_field", "lap_field"],
        "smem_bytes": [],
        "snapshots": [],
        "sweep": [],
        "tile": None,
        "tiles": [{"ctas_per_sm": 4,
                   "halo": 1.0343,
                   "kernel": "dycore_fused_float32_k0_tile",
                   "kz": 4,
                   "planes": 3,
                   "slots": 3,
                   "smem_bytes": 47376,
                   "staged": ["u@k0"],
                   "tile": [32, 64]}],
        "widened": {},
    },
    "fv_step_float32": {
        "columns": [],
        "declined": {"kblocked": "one pass, the default (k_blocked=True blocks)"},
        "forms": ["tile"],
        "kblocked": False,
        "registers": ["a6fx", "a6fy", "a6x", "a6y", "brfx", "brfy", "brx", "bry", "dmfx",
                      "dmfy", "dmx", "dmy", "fnegx", "fnegy", "fnfx", "fnfy", "fpfx", "fpfy",
                      "fposx", "fposy", "smfx", "smfy", "smx", "smy"],
        "scratch": [],
        "serialized": False,
        "shared": ["a6lfx", "a6lfy", "a6lx", "a6ly", "alfx", "alfy", "alx", "aly", "blfx",
                   "blfy", "blmfx", "blmfy", "blmx", "blmy", "blx", "bly", "brmfx", "brmfy",
                   "brmx", "brmy", "dmlfx", "dmlfy", "dmlx", "dmly", "fluxx", "fluxy", "fx",
                   "fy", "qx", "qy"],
        "smem_bytes": [],
        "snapshots": [],
        "sweep": [],
        "tile": None,
        "tiles": [{"ctas_per_sm": 3,
                   "halo": 1.1551,
                   "kernel": "fv_step_float32_k0_tile",
                   "kz": 4,
                   "planes": 30,
                   "slots": 9,
                   "smem_bytes": 59248,
                   "staged": ["q@k0"],
                   "tile": [32, 32]}],
        "widened": {},
    },
    "hdiff_float32": {
        "columns": [],
        "declined": {"kblocked": "one pass, the default (k_blocked=True blocks)"},
        "forms": ["tile"],
        "kblocked": False,
        "registers": ["res"],
        "scratch": [],
        "serialized": False,
        "shared": ["flx_field", "fly_field", "lap_field"],
        "smem_bytes": [],
        "snapshots": [],
        "sweep": [],
        "tile": None,
        "tiles": [{"ctas_per_sm": 4,
                   "halo": 1.0343,
                   "kernel": "hdiff_float32_k0_tile",
                   "kz": 4,
                   "planes": 3,
                   "slots": 3,
                   "smem_bytes": 47376,
                   "staged": ["in_field@k0"],
                   "tile": [32, 64]}],
        "widened": {},
    },
    "vadv_float32": {
        "columns": [{"carries": ["datacol"],
                     "columns": ["ccol", "dcol"],
                     "kernel": "vadv_float32_k2_col",
                     "loops": 2,
                     "prefetch": 29}],
        "declined": {"kblocked": "one pass, the default (k_blocked=True blocks)"},
        "forms": ["column"],
        "kblocked": False,
        "registers": ["acol", "as_", "bcol", "correction_term", "cs", "divided", "gav", "gcv"],
        "scratch": ["ccol", "dcol", "datacol"],
        "serialized": False,
        "shared": [],
        "smem_bytes": [],
        "snapshots": [],
        "sweep": [],
        "tile": None,
        "tiles": [],
        "widened": {},
    },
    "vadv_upd_float32": {
        "columns": [{"carries": ["datacol"],
                     "columns": ["ccol", "dcol"],
                     "kernel": "vadv_upd_float32_k2_col",
                     "loops": 2,
                     "prefetch": 29}],
        "declined": {"kblocked": "one pass, the default (k_blocked=True blocks)"},
        "forms": ["column"],
        "kblocked": False,
        "registers": ["acol", "as_", "bcol", "correction_term", "cs", "divided", "gav", "gcv"],
        "scratch": ["ccol", "dcol", "datacol"],
        "serialized": False,
        "shared": [],
        "smem_bytes": [],
        "snapshots": [],
        "sweep": [],
        "tile": None,
        "tiles": [],
        "widened": {},
    },
}


def test_headline_plans_unchanged():
    """MiniDycore's and FvAdvection's stencils at 512x512x80 float32 keep
    their plans: one pass (no K4), the same forms, tiles and storage, in
    the record ``LAST_PLAN`` takes at build and at a launch at depth 80
    (before the call's vector and repair entries)."""
    from gt4py_tpu_torch.models import dycore, fv_advection

    for st in (dycore.make_hdiff(np.float32), dycore.make_vadv(np.float32),
               dycore.make_vadv_update(np.float32), dycore.make_dycore_fused(np.float32),
               fv_advection.make_fv_step(np.float32)):
        assert st.backend.program.plan_record() == HEADLINE_PLANS[st.name], st.name
        assert st.backend._depth_plan(512 * 512, 80)[1] == HEADLINE_PLANS[st.name], st.name
