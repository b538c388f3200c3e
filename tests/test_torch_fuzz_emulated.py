"""The program fuzzer on the generated CUDA kernels, built by the host
compiler against the emulated runtime of ``tests/test_torch_emulated.py``.

Each seed's program runs on ``"cuda"`` (its kernels, counted by its
library: at least one launch) and on ``"torch"``, and both are held to the
JAX package's ``"numpy"`` oracle at rtol = atol = 1e-12 (float64), the
kernels to the plain executor at the same bound: the JAX fuzzer's C-order
arrays (``ijk``, K contiguous: element staging) for seeds 0-15, the tight
(K, I, J) buffers with an odd row pitch (``kij_tight``: row-phase staging)
for seeds 0-7, and builds with ``serialize=True`` (K5's plane-sweep and
sweep forms; ``sweep=True`` first, where it plans) for seeds 0-3.  Each
call's launches, counted by its library by kernel, add up by form to its
total.  No program declines: the ones that once did (``DECLINED``) run
their kernels, equal to the plain executor bit for bit.  Each fault the
fuzzer found has a named seed test here.
"""

import numpy as np
import pytest

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript, ir
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.testing import program_gen

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401
from .test_torch_fuzz import jax_oracle


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def _check(case):
    """Both legs against the JAX oracle; no program declines."""
    assert case.declined is None, case.declined
    assert case.launches >= 1
    assert sum(case.forms.values()) == case.launches, (case.forms, case.launch_counts)
    ref = jax_oracle(case, case.periodic)
    for name in case.names:
        for backend in ("cuda", "torch"):
            np.testing.assert_allclose(case.results[backend][name], ref[name], rtol=1e-12,
                                       atol=1e-12, err_msg=f"{backend} {name}")


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_ijk_emulated(emulated, seed):  # noqa: F811
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True, allow_declines=True)
    _check(case)
    assert case.declined or set(case.plan["staging"].values()) <= {"element"}


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_kij_tight_emulated(emulated, seed):  # noqa: F811
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             layout="kij_tight", count_kernels=True,
                                             allow_declines=True)
    _check(case)
    assert case.declined or set(case.plan["staging"].values()) <= {"row_phase"}


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_serialized_emulated(emulated, seed):  # noqa: F811
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             layout="kij_aligned",
                                             options=program_gen.SERIALIZED_BUILDS,
                                             count_kernels=True)
    _check(case)
    # a serialized build, which serializes every program with a PARALLEL loop
    assert case.options in program_gen.SERIALIZED_BUILDS
    assert case.backend("cuda").program.serialized == any(
        loop.loop_order == ir.LoopOrder.PARALLEL for loop in case.stencil.vertical_loops)


@pytest.mark.parametrize("seed", [24])
def test_fuzz_regression_while_reads_its_own_writes(emulated, seed):  # noqa: F811
    """Fuzz-found (seed 24): a ``while`` in a serial loop's plane-sweep
    kernel read its counter from the snapshot taken before the kernel, so
    its own increments never reached its condition and the kernel did not
    terminate; such reads now go to the shared plane, primed from the
    snapshot before the statement."""
    _check(program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True))


@pytest.mark.parametrize("seed", [16, 19, 25])
def test_fuzz_regression_split_if_with_offset_self_read(emulated, seed):  # noqa: F811
    """Fuzz-found (seeds 16, 19, 25): an ``if`` whose statements read at an
    offset a field it writes made the build raise; it is split into a mask
    temporary and one guarded statement each
    (``passes.split_compound_statements``)."""
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True)
    _check(case)
    assert any(n.startswith("__split_mask")
               for n in case.backend("cuda").program.analysis.stencil.temp_decls)


@pytest.mark.parametrize("seed", [236, 379])
def test_fuzz_regression_split_pieces_keep_the_statement_extent(emulated, seed):  # noqa: F811
    """Fuzz-found (seeds 236, 379): the pieces of a split ``if`` each took
    their own extent, so they wrote where the oracle's one statement does
    not (a temporary read beyond it, an output at a halo point it does
    cover); every piece now keeps the statement's extent and writes only
    within it."""
    _check(program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True))


@pytest.mark.parametrize("seed", [11])
def test_fuzz_regression_while_reads_its_neighbours_writes(emulated, seed):  # noqa: F811
    """Fuzz-found (seed 11): a ``while`` in a serial loop that reads at a
    horizontal offset a field it writes (``tmp0[1, 0, 0]``) had no kernel
    form; the plane-sweep kernel now runs it one iteration at a time for
    the whole CTA over its extent grown by the reach
    (``cuda_backend._loop_group``, ``__syncthreads_or``)."""
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True)
    _check(case)
    assert "planes" in case.plan["forms"]
    assert "__syncthreads_or" in case.backend("cuda").source


@pytest.mark.parametrize("seed", [6])
def test_fuzz_regression_ring_read_runs_a_launch_a_level(emulated, seed):  # noqa: F811
    """Fuzz-found (the wide leg, seed 6 at 37 x 70 x 23): a plane-sweep
    read of an earlier level whose writer could not be widened (it reads
    fields two other writers of the level compute) made the build decline;
    the kernel now runs one launch a level and reads earlier levels from
    device memory (``PlanePlan.per_level``, ``LAST_PLAN[...]["declined"]
    ["ring"]``)."""
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             layout="kij_tight", domain=(37, 70, 23),
                                             count_kernels=True)
    _check(case)
    assert "one launch a level" in case.plan["declined"]["ring"]
    assert case.launches > 23
    # the library counts every level's launch of the plane-sweep kernel
    assert case.forms["planes"] >= 23


@pytest.mark.parametrize("seed", [21])
def test_fuzz_regression_widen_only_reachable_writers(emulated, seed):  # noqa: F811
    """Fuzz-found (seed 21): a plane-sweep read of an earlier level made
    the planner widen every writer of the field, among them a ``while`` in
    a section whose levels the read never reaches, and decline; writers at
    unreachable levels are now left as they are."""
    _check(program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             count_kernels=True))


@pytest.mark.parametrize("seed", [1, 3])
def test_fuzz_regression_k4_reads_read_only_fields_at_variable_k(emulated, seed):  # noqa: F811
    """Fuzz-found (the deep leg, seeds 1 and 3 at 8 x 8 x 600): K4 declined
    every stencil with a variable or absolute K read, so no deep program
    reached it; such reads of fields the stencil only reads now run K4,
    from device memory."""
    case = program_gen.run_differential_case(seed, backends=("torch", "cuda"),
                                             layout="kij_aligned", domain=(8, 8, 600),
                                             count_kernels=True)
    _check(case)
    assert isinstance(case.plan["kblocked"], dict)


#: programs the ``"cuda"`` backend declined until the plane form widened
#: the writers before a CTA-iterated ``while`` (147, 386) and the tile form
#: iterated such a loop itself (199): (seed, domain) -> the kernel form the
#: loop now runs in
DECLINED = {
    (147, None): "planes",
    (199, None): "tile",
    (386, None): "planes",
}


@pytest.mark.parametrize("seed,domain", sorted(DECLINED, key=str))
def test_fuzz_declines_are_named(emulated, seed, domain):  # noqa: F811
    """The programs the kernels once declined build and run on ``"cuda"``
    (its kernels, built by the host compiler against the emulated runtime,
    counted by its library), equal to ``"torch"`` bit for bit, and both
    equal the JAX oracle at 1e-12 in float64; none is pinned as a card
    leg's decline."""
    case = program_gen.run_differential_case(seed, domain=domain, backends=("torch", "cuda"),
                                             count_kernels=True)
    assert case.declined is None and case.launches >= 1
    assert DECLINED[(seed, domain)] in case.forms, case.forms
    for name in case.names:
        np.testing.assert_array_equal(case.results["cuda"][name], case.results["torch"][name],
                                      err_msg=name)
    ref = jax_oracle(case)
    for name in case.names:
        for backend in ("cuda", "torch"):
            np.testing.assert_allclose(case.results[backend][name], ref[name], rtol=1e-12,
                                       atol=1e-12, err_msg=f"{backend} {name}")
    assert not program_gen.LEG_DECLINES


def _one_stage_loop(a: gtscript.Field[np.float64], b: gtscript.Field[np.float64]):
    with computation(FORWARD), interval(...):
        tmp = a
    with computation(PARALLEL), interval(...):
        while tmp < 0.5:
            tmp = tmp + 0.25
            b = tmp[1, 0, 0]


def test_tile_form_runs_a_one_stage_loop_section(emulated):  # noqa: F811
    """A PARALLEL section that is one CTA-iterated ``while`` runs the tile
    kernel (the row form, which one-stage sections otherwise take, cannot
    iterate it), equal to the plain executor bit for bit."""
    from gt4py_tpu_torch import testing

    def inputs():
        rng = np.random.default_rng(5)
        return {"a": rng.random((10, 12, 4)) - 0.5, "b": np.zeros((10, 12, 4))}, {}

    got, ref, st = testing.run_pair(_one_stage_loop, inputs,
                                    dict(origin=(0, 0, 0), domain=(9, 12, 4)), "cpu")
    assert [k.form for k in st.backend.program.kernels][-1] == "tile"
    assert st.backend.launches == 1
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
