"""The port stands alone: importing every ``gt4py_tpu_torch`` module (the
next DSL's, the distribution layer's -- ``parallel`` with its phased
calls, ``next.distributed``, ``utils``, ``io`` -- and the examples
included), or the chip check, loads no ``jax``, no ``ml_dtypes`` and
nothing of ``gt4py_tpu``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {root!r})
import gt4py_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gt4py_tpu_torch.__path__, "gt4py_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "gt4py_tpu"))
assert "gt4py_tpu_torch.next.cuda_bridge" in names, names
assert "gt4py_tpu_torch.next.ffront" in names, names
for n in ("parallel.mesh", "parallel.halo", "parallel.distributed", "parallel.phases",
          "parallel.dryrun", "next.distributed", "next.testing", "utils.checkpoint",
          "utils.resilience", "io", "testing.dist_cases", "instrumentation.metrics",
          "examples", *("examples." + e for e in gt4py_tpu_torch.examples.EXAMPLES)):
    assert "gt4py_tpu_torch." + n in names, n
print(len(names), bad)
"""


def test_port_imports_no_jax():
    code = _PROBE.format(root=ROOT, smoke=os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]", bad


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the chip check exits non-zero and prints no
    result."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _code_lines(path):
    """The C++ source's lines outside ``//`` comments."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.lstrip().startswith("//")]


def test_router_is_a_copy_in_the_port():
    """The Beneš router the port builds is its own copy of the JAX
    package's host C++ (the same code; only the header comment differs),
    and no module of the port names the JAX package's native directory."""
    port = os.path.join(ROOT, "gt4py_tpu_torch", "csrc", "benes_router.cpp")
    assert _code_lines(port) == _code_lines(os.path.join(ROOT, "gt4py_tpu", "native",
                                                         "benes_router.cpp"))
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gt4py_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                with open(os.path.join(dirpath, name)) as f:
                    assert "gt4py_tpu/native" not in f.read().replace(
                        "A copy of gt4py_tpu/native", ""), name


def test_gridio_is_a_copy_in_the_port():
    """The grid IO the port builds is its own copy of the JAX package's C++
    (the same code; only the header comment differs)."""
    port = os.path.join(ROOT, "gt4py_tpu_torch", "csrc", "gridio.cpp")
    assert _code_lines(port) == _code_lines(os.path.join(ROOT, "gt4py_tpu", "io", "_native",
                                                         "gridio.cpp"))
