"""The port's entry points run on the card unless the caller asks for the
CPU (``device="cpu"`` or ``GT4PY_TPU_TORCH_DEVICE=cpu``): the default
device is ``"cuda"``, ``@stencil``, the models and their factories
default to the ``"cuda"`` backend, and an entry point called without a
device on a machine without a GPU raises instead of running on the CPU."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config, storage
from gt4py_tpu_torch.models import dycore, full_dycore, fv_advection, semi_lagrangian
from gt4py_tpu_torch.next import testing as next_testing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config_defaults(**env):
    base = {k: v for k, v in os.environ.items() if not k.startswith("GT4PY_TPU_TORCH_")}
    code = ("import sys; sys.path.insert(0, %r); from gt4py_tpu_torch import config; "
            "print(config.DEFAULT_DEVICE, config.DEFAULT_BACKEND)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**base, **env}, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_config_defaults_to_the_card():
    assert _config_defaults() == ["cuda", "cuda"]


def test_config_cpu_on_request():
    assert _config_defaults(GT4PY_TPU_TORCH_DEVICE="cpu")[0] == "cpu"


FACTORIES = [
    (m, name) for m in (dycore, fv_advection, semi_lagrangian)
    for name, fn in sorted(vars(m).items())
    if name.startswith("make_") and inspect.isfunction(fn) and fn.__module__ == m.__name__
]


@pytest.mark.parametrize("module,name", FACTORIES, ids=[n for _, n in FACTORIES])
def test_factories_default_to_cuda(module, name):
    assert inspect.signature(getattr(module, name)).parameters["backend"].default == "cuda"


@pytest.mark.parametrize("model", [dycore.MiniDycore, fv_advection.FvAdvection,
                                   full_dycore.FullDycore])
def test_models_default_to_cuda(model):
    params = inspect.signature(model.__init__).parameters
    assert params["backend"].default == "cuda"
    assert params["device"].default is None  # None: config.DEFAULT_DEVICE


#: entry points called without a device
ENTRY_POINTS = {
    "storage.zeros": lambda: storage.zeros((4, 4, 2)),
    "storage.from_array": lambda: storage.from_array(np.ones((4, 4, 2))),
    "MiniDycore": lambda: dycore.MiniDycore(8, 8, 4),
    "FvAdvection": lambda: fv_advection.FvAdvection(8, 8, 4),
    "FullDycore": lambda: full_dycore.FullDycore(8, 8, 4),
    "state_from_numpy": lambda: dycore.state_from_numpy({"u": np.zeros(3)}),
    "next.as_field": lambda: gtx.as_field((gtx.Dimension("I"),), np.zeros(3)),
    "next.zeros": lambda: gtx.zeros({gtx.Dimension("I"): 3}),
    "next.as_connectivity": lambda: gtx.as_connectivity(
        np.zeros((3, 2), np.int32), source=gtx.Dimension("E"), codomain=gtx.Dimension("V")),
    "unstructured_fvm_case": lambda: next_testing.unstructured_fvm_case(4),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(monkeypatch, name):
    """No GPU and no device given: the entry point raises; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert storage.zeros((4, 4, 2), device="cpu").device.type == "cpu"
    m = dycore.MiniDycore(8, 8, 4, device="cpu")
    assert m.init_state()["u"].device.type == "cpu"
    assert gtx.as_field((gtx.Dimension("I"),), np.zeros(3), device="cpu").data.device.type \
        == "cpu"
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")
    assert storage.zeros((4, 4, 2)).device.type == "cpu"
