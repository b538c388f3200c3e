"""``instrumentation.profile_range`` on the CPU: a ``torch.profiler``
range (``record_function``), and no NVTX call while the process has not
initialised CUDA (on the card it also opens an NVTX range:
``tests/test_torch_cuda.py``)."""

import torch

from gt4py_tpu_torch.instrumentation import profile_range


def test_profile_range_on_the_cpu(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.cuda.nvtx, "range", lambda name: opened.append(name))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile_range("gt4py_tpu_torch_range"):
            torch.ones(8).sum()
    assert opened == []
    assert "gt4py_tpu_torch_range" in {e.key for e in prof.key_averages()}


def test_profile_range_opens_nvtx_once_cuda_is_up(monkeypatch):
    """Where CUDA is initialised the range is also an NVTX range (here the
    NVTX call is recorded instead of made) and ``record_function`` stays."""
    import contextlib

    opened = []

    @contextlib.contextmanager
    def nvtx_range(name):
        opened.append(name)
        yield

    monkeypatch.setattr(torch.cuda.nvtx, "range", nvtx_range)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile_range("gt4py_tpu_torch_nvtx"):
            torch.ones(8).sum()
    assert opened == ["gt4py_tpu_torch_nvtx"]
    assert "gt4py_tpu_torch_nvtx" in {e.key for e in prof.key_averages()}
