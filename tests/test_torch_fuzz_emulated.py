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
total.  A
program the kernels have no form for (``DECLINED``) declines at build
with ``NotImplementedError`` naming why, and its plain leg is still held
to the oracle.  Each fault the fuzzer found has a named seed test here.
"""

import numpy as np
import pytest

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.testing import program_gen

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401
from .test_torch_fuzz import jax_oracle


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


def _check(case):
    """Both legs against the JAX oracle; a program the kernels decline
    (``DECLINED``) runs its plain leg only."""
    if case.declined is not None:
        assert any(why in case.declined for why in DECLINED.values()), case.declined
    else:
        assert case.launches >= 1
        assert sum(case.forms.values()) == case.launches, (case.forms, case.launch_counts)
    ref = jax_oracle(case, case.periodic)
    for name in case.names:
        for backend in ("cuda", "torch")[case.declined is not None:]:
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


#: programs the ``"cuda"`` backend has no kernel form for (ROADMAP Queue 3,
#: open): (seed, domain) -> the reason its build names
DECLINED = {
    (147, None): "a while loop iterated by the CTA reads 'tmp0', which the",
    (199, None): "a compound statement reads a field it writes at an offset",
}


@pytest.mark.parametrize("seed,domain", sorted(DECLINED, key=str))
def test_fuzz_declines_are_named(seed, domain):
    """The programs the kernels cannot run decline at build with
    ``NotImplementedError`` naming why (nothing runs), and their plain
    runs still match the JAX oracle."""
    case = program_gen.DifferentialCase(seed, domain=domain)
    with pytest.raises(NotImplementedError, match=DECLINED[(seed, domain)]):
        case.backend("cuda")
    case = program_gen.run_differential_case(seed, domain=domain, backends=("torch", "cuda"),
                                             allow_declines=True)
    assert DECLINED[(seed, domain)] in case.declined
    assert "cuda" not in case.results
    if domain is None:
        ref = jax_oracle(case)
        for name in case.names:
            np.testing.assert_allclose(case.results["torch"][name], ref[name], rtol=1e-12,
                                       atol=1e-12)
