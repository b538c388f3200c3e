"""The port's cartesian call surface against the JAX package's.

- the call hooks: ``StencilObject.__call__`` runs inside
  ``instrumentation.stencil_call_context``, keeps ``exec_info``'s times and
  its ``"__aggregate_data"`` per-stencil totals, and records the
  ``call_time`` metric, as the JAX package's does; ``run`` and
  ``FrozenStencil`` go straight to the run;
- ``run``, ``freeze``, ``__gt_dims__`` reordering, ``pretty_ir`` (the JAX
  package's text for every ``tests/cartesian/stencil_defs.py``
  definition), ``lowered`` (``"ir"``, ``"cuda"``, ``"plan"``);
- the port's ``"numpy"`` backend bit for bit equal to the JAX package's on
  every stencil_defs definition, ``"debug"`` equal to ``"numpy"``, both
  host-only (a CUDA or meta tensor raises ``ArgumentError``, bfloat16
  ``TypeError``);
- the artifact cache across two processes, the ``cache_manager`` CLI and
  ``.gt.py`` imports.
"""

import contextlib
import linecache
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gt4py_tpu import config as j_config
from gt4py_tpu import instrumentation as j_instr
from gt4py_tpu.cartesian import gtscript as j_gtscript

from gt4py_tpu_torch import config
from gt4py_tpu_torch import instrumentation as p_instr
from gt4py_tpu_torch import testing
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval
from gt4py_tpu_torch.cartesian.stencil_object import ArgumentError, FrozenStencil

from .cartesian import stencil_defs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


_PROBE = '''
def call_probe(a: Field[np.float64], b: Field[np.float64], *, w: np.float64):
    with computation(PARALLEL), interval(...):
        b = a[1, 0, 0] + w * a
'''


def _define(gts, name):
    """``_PROBE`` defined on the gtscript module ``gts`` (the frontends
    read the source back through linecache)."""
    filename = f"<call-surface-{name}>"
    linecache.cache[filename] = (len(_PROBE), None, _PROBE.splitlines(True), filename)
    ns = dict(Field=gts.Field, np=np, computation=gts.computation, interval=gts.interval,
              PARALLEL=gts.PARALLEL)
    exec(compile(_PROBE, filename, "exec"), ns)
    return ns["call_probe"]


def _hooked(ctx, events):
    @contextlib.contextmanager
    def hook(**kw):
        events.append(("enter", kw["name"]))
        yield
        events.append(("exit", kw["name"]))

    ctx.register(hook)
    return hook


def test_call_hooks_match_the_jax_package(monkeypatch):
    """One hook on each package's ``stencil_call_context``: the same
    definition called twice with ``exec_info={"__aggregate_data": True}``
    on the JAX ``"numpy"`` and the port's ``"torch"`` backend gives the
    same activations, the same ``exec_info`` keys and totals, and a
    ``call_time`` sample; ``run`` and a frozen stencil activate nothing."""
    monkeypatch.setattr(config, "COLLECT_METRICS_LEVEL", 20)
    monkeypatch.setattr(j_config, "COLLECT_METRICS_LEVEL", 20)
    seen = {}
    for label, instr, gts, backend in (("jax", j_instr, j_gtscript, "numpy"),
                                       ("port", p_instr, gtscript, "torch")):
        events = []
        hook = _hooked(instr.stencil_call_context, events)
        try:
            st = gts.stencil(backend=backend, definition=_define(gts, label), rebuild=True)
            a, b = np.random.default_rng(0).random((5, 4, 3)), np.zeros((5, 4, 3))
            info = {"__aggregate_data": True}
            for _ in range(2):
                st(a, b, w=0.5, origin=(0, 0, 0), domain=(4, 4, 3), exec_info=info)
            n_calls = len(events)
            st.run(a=a, b=b, w=0.5, _domain_=(4, 4, 3), _origin_={"_all_": (0, 0, 0)})
            st.freeze(origin={"_all_": (0, 0, 0)}, domain=(4, 4, 3))(a=a, b=b, w=0.5)
            assert len(events) == n_calls
        finally:
            instr.stencil_call_context.unregister(hook)
        stats = info["call_probe"]
        assert stats["ncalls"] == 2
        assert stats["total_call_time"] >= stats["call_time"] > 0
        assert stats["total_run_time"] >= stats["run_time"] > 0
        assert instr.collection("call_probe").metric("call_time").count >= 2
        seen[label] = (events, sorted(info), sorted(stats))
    assert seen["port"] == seen["jax"]


def test_run_freeze_and_gt_dims():
    st = gtscript.stencil(backend="torch", definition=_define(gtscript, "run"), rebuild=True)
    a = np.random.default_rng(1).random((6, 5, 4))
    b = np.zeros_like(a)
    st(a, b, w=2.0, origin=(0, 0, 0), domain=(5, 5, 4))
    ref = b.copy()
    np.testing.assert_array_equal(ref[:5], a[1:] + 2.0 * a[:5])
    b[:] = 0
    st.run(a=a, b=b, w=2.0, _domain_=(5, 5, 4), _origin_={"_all_": (0, 0, 0)})
    np.testing.assert_array_equal(b, ref)
    frozen = st.freeze(origin={"_all_": (0, 0, 0)}, domain=(5, 5, 4))
    assert isinstance(frozen, FrozenStencil)
    b[:] = 0
    frozen(a=a, b=b, w=2.0)
    np.testing.assert_array_equal(b, ref)
    # a (K, J, I) tensor carrying __gt_dims__ is permuted to (I, J, K), and
    # the written one is written through the permuted view
    kji = torch.from_numpy(np.ascontiguousarray(a.transpose(2, 1, 0)))
    kji.__gt_dims__ = ("K", "J", "I")
    out = torch.zeros(4, 5, 6, dtype=torch.float64)
    out.__gt_dims__ = ("K", "J", "I")
    st(kji, out, w=2.0, origin=(0, 0, 0), domain=(5, 5, 4))
    np.testing.assert_array_equal(out.numpy().transpose(2, 1, 0), ref)
    bad = torch.from_numpy(a.copy())
    bad.__gt_dims__ = ("I", "J", "X")
    with pytest.raises(ArgumentError, match="__gt_dims__"):
        st(bad, b, w=2.0, origin=(0, 0, 0), domain=(5, 5, 4))


def _run_entry(entry, gts, backend):
    st = gts.stencil(backend=backend, definition=entry["definition"],
                     externals=entry["externals"], rebuild=True)
    inputs = entry["make_inputs"]()
    fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    kw = {k: entry[k] for k in ("origin", "domain") if entry[k] is not None}
    st(**fields, **scalars, **kw)
    return st, fields


PORT_DEFS = testing.load_stencil_defs()


@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_numpy_backend_bitwise_and_pretty_ir(name):
    """The port's ``"numpy"`` is the JAX package's oracle bit for bit, and
    ``pretty_ir`` gives the JAX package's text."""
    jst, ref = _run_entry(stencil_defs.REGISTRY[name], j_gtscript, "numpy")
    pst, got = _run_entry(PORT_DEFS[name], gtscript, "numpy")
    assert pst.pretty_ir() == jst.pretty_ir()
    assert pst.lowered(format="ir") == jst.lowered(format="ir")
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_debug_backend_bitwise_vs_numpy(name):
    _, ref = _run_entry(PORT_DEFS[name], gtscript, "numpy")
    _, got = _run_entry(PORT_DEFS[name], gtscript, "debug")
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("backend", ["numpy", "debug"])
def test_host_backends_refuse_device_tensors_and_bfloat16(backend):
    st = gtscript.stencil(backend=backend, definition=_define(gtscript, "host"), rebuild=True)
    a = torch.zeros(5, 4, 3, dtype=torch.float64, device="meta")
    with pytest.raises(ArgumentError, match="runs on the host"):
        st(a, torch.zeros_like(a), w=1.0, origin=(0, 0, 0), domain=(4, 4, 3))

    def bf(a: gtscript.Field[gtscript.bfloat16], b: gtscript.Field[gtscript.bfloat16]):
        with computation(PARALLEL), interval(...):
            b = a

    st = gtscript.stencil(backend=backend, definition=bf, rebuild=True)
    t = torch.zeros(3, 3, 3, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        st(t, t.clone(), origin=(0, 0, 0))


def test_lowered_formats():
    st = gtscript.stencil(backend="cuda", definition=_define(gtscript, "lowered"),
                          rebuild=True)
    assert "computation(PARALLEL)" in st.lowered(format="ir")
    assert st.lowered(format="cuda") == st.backend.source
    assert "__global__" in st.lowered(format="cuda")
    # the plan a call at the domain writes, without allocating or running
    before = st.backend.launches
    plan = st.lowered(format="plan", domain=(64, 96, 6), physical_layout=True)
    assert st.backend.launches == before
    assert plan["forms"] == ["rows"]
    assert st.lowered(format="plan", domain=(64, 96, 6))["declined"]["vector"]
    with pytest.raises(ValueError, match="ir | cuda | plan"):
        st.lowered(format="hlo")
    nb = gtscript.stencil(backend="numpy", definition=_define(gtscript, "lowered_np"),
                          rebuild=True)
    assert "stencil" in nb.lowered(format="ir")
    with pytest.raises(TypeError, match="no lowered form"):
        nb.lowered(format="cuda")


def test_lowered_plan_of_a_deep_call_has_k4():
    """At 8x8x600 a column loop runs K4 by default: the dry plan records
    its blocks (CTAs a SM by the shared-memory rule)."""
    st = gtscript.stencil(backend="cuda", definition=PORT_DEFS["forward_cumsum"]["definition"],
                          rebuild=True)
    plan = st.lowered(format="plan", domain=(8, 8, 600))
    assert isinstance(plan["kblocked"], dict), plan["declined"]
    assert plan["kblocked"]["ctas_per_sm"][0] >= 1
    assert cuda_backend.LAST_PLAN.get(st.name, {}).get("kblocked") is not plan["kblocked"]


_CACHE_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from gt4py_tpu_torch.models.fv_advection import FvAdvection

m = FvAdvection(12, 12, 3, dtype=np.float64, backend="torch", device="cpu", aligned=False)
state = m.init_state(seed=1)
out = m.step_fn()(state["q"], state["cx"], state["cy"])
print("CHECKSUM", repr(float(out.double().sum())))
"""


def test_warm_artifact_cache_is_bitwise_identical(tmp_path):
    """Two processes: the first parses and stores each stencil's IR under
    ``GT4PY_TPU_TORCH_CACHE_ROOT``, the second loads it; the results are the
    same bit for bit."""
    script = tmp_path / "drive.py"
    script.write_text(_CACHE_SCRIPT.format(repo=ROOT))
    env = {**os.environ, "GT4PY_TPU_TORCH_CACHE_ROOT": str(tmp_path / "cache")}

    def run():
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             env=env, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        return [ln for ln in out.stdout.splitlines() if ln.startswith("CHECKSUM")]

    cold = run()
    assert any((tmp_path / "cache" / "artifacts").iterdir())
    assert run() == cold


def test_artifact_cache_key_covers_the_frontend(tmp_path, monkeypatch):
    """An entry's name holds a hash of the frontend's and the passes'
    sources: IR parsed by another tree's frontend is never loaded."""
    import shutil

    from gt4py_tpu_torch.cartesian import artifact_cache

    here = os.path.join(ROOT, "gt4py_tpu_torch", "cartesian")
    for rel in artifact_cache.FRONTEND_MODULES:
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(here, rel), tmp_path / rel)
    assert artifact_cache.sources_hash(str(tmp_path)) == artifact_cache.frontend_hash()
    with open(tmp_path / "passes.py", "a") as f:
        f.write("\n# another tree\n")
    other = artifact_cache.sources_hash(str(tmp_path))
    assert other != artifact_cache.frontend_hash()
    monkeypatch.setattr(artifact_cache.config, "CACHE_ROOT", str(tmp_path / "cache"))
    monkeypatch.setattr(artifact_cache.config, "ARTIFACT_CACHE", True)
    assert artifact_cache.frontend_hash() in artifact_cache._path("sid")

    def copy(a: gtscript.Field[np.float64], b: gtscript.Field[np.float64]):
        with computation(PARALLEL), interval(...):
            b = a

    st = gtscript.stencil(backend="torch", definition=copy, rebuild=True)
    artifact_cache.save("sid", st.analysis)
    assert artifact_cache.load("sid").stencil.name == st.analysis.stencil.name
    monkeypatch.setattr(artifact_cache, "frontend_hash", lambda: other)
    assert artifact_cache.load("sid") is None


def test_cache_manager_cli(tmp_path):
    env = {**os.environ, "GT4PY_TPU_TORCH_CACHE_ROOT": str(tmp_path / "cache"),
           "GT4PY_TPU_TORCH_BUILD_DIR": str(tmp_path / "build")}
    for d in ("cache/artifacts", "build/abc"):
        os.makedirs(tmp_path / d)
        (tmp_path / d / "blob").write_bytes(b"x" * 100)

    def cli(cmd):
        out = subprocess.run([sys.executable, "-m", "gt4py_tpu_torch.cache_manager", cmd],
                             capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout

    info = cli("info")
    assert "cache root" in info and "build dir" in info and "files" in info
    cleaned = cli("clean")
    assert str(tmp_path / "cache") in cleaned and str(tmp_path / "build") in cleaned
    assert not (tmp_path / "cache").exists() and not (tmp_path / "build").exists()
    from gt4py_tpu_torch.cartesian import caching, gt_cache_manager

    assert caching.load is not None and gt_cache_manager.main is not None


def test_import_gt_py_file(tmp_path):
    src = textwrap.dedent(
        """
        import numpy as np
        from gt4py_tpu_torch.cartesian import gtscript
        from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

        @gtscript.stencil(backend="torch")
        def doubled(a: gtscript.Field[np.float64], b: gtscript.Field[np.float64]):
            with computation(PARALLEL), interval(...):
                b = a * 2.0

        CONSTANT = 41
        """
    )
    (tmp_path / "port_imported_stencils.gt.py").write_text(src)
    from gt4py_tpu_torch.cartesian import gtscript_imports

    with gtscript_imports.enabled(search_path=[tmp_path]):
        import port_imported_stencils  # noqa: F401
    try:
        assert port_imported_stencils.CONSTANT == 41
        a = np.ones((3, 3, 3))
        b = np.zeros_like(a)
        port_imported_stencils.doubled(a, b, origin=(0, 0, 0))
        assert (b == 2.0).all()
        assert port_imported_stencils.__file__.endswith(".gt.py")
    finally:
        del sys.modules["port_imported_stencils"]
    (tmp_path / "port_scoped_mod.gt.py").write_text("X = 1\n")
    with gtscript_imports.enabled(search_path=[tmp_path]):
        import port_scoped_mod

        assert port_scoped_mod.X == 1
    del sys.modules["port_scoped_mod"]
    with pytest.raises(ImportError):
        import port_scoped_mod  # noqa: F401,F811
