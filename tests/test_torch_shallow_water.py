"""The port's ShallowWater model and spectral transforms against
``gt4py_tpu``'s, on the CPU.

- ``ShallowWater`` at 16x256x4 float64, ``step_fn`` (periodic, aligned
  buffers) and ``local_step_fn`` (non-periodic, the tight halo-2 buffers),
  on ``"torch"`` and on ``"cuda"`` with the emulated kernels of
  ``tests/test_torch_emulated.py``, against the JAX model on ``"jax"`` from
  the same numpy state at rtol 1e-12 / atol 1e-14, and against its numpy
  oracle; the emulated kernels run the vector row form, on the tight
  buffers by a phase shift and no copy (J rows of 260 items, 2080 bytes;
  the origin at J 2).
- Mass conservation over 20 periodic steps, as tests/models checks it.
- ``spectral_filter`` and ``poisson_solve`` against
  ``gt4py_tpu.models.spectral`` and the port's numpy copies (rtol 1e-10:
  two FFT libraries).
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.models import shallow_water as j_sw
from gt4py_tpu.models import spectral as j_spec

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.models import ShallowWater, spectral
from gt4py_tpu_torch.models.dycore import state_from_numpy

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


NI, NJ, NK = 16, 256, 4
HW = ShallowWater.HALO
TOL = dict(rtol=1e-12, atol=1e-14)


def _jax_step(aligned, local, state):
    import jax.numpy as jnp

    jm = j_sw.ShallowWater(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=aligned)
    step = jm.local_step_fn() if local else jm.step_fn()
    return [np.asarray(x) for x in step(*(jnp.asarray(state[k]) for k in "huv"))]


def _port(request, backend):
    if backend == "cuda":
        request.getfixturevalue("emulated")


@pytest.mark.parametrize("local", [False, True], ids=["step", "local_step"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sw_step_vs_jax(request, backend, aligned, local):
    """One step from the JAX model's numpy state: every element of the
    three outputs, halos included, at rtol 1e-12; the inputs unchanged."""
    _port(request, backend)
    jm = j_sw.ShallowWater(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=aligned)
    state = jm.init_state(seed=1)
    pm = ShallowWater(NI, NJ, NK, dtype=np.float64, backend=backend, aligned=aligned,
                      device="cpu")
    t = state_from_numpy(state, "cpu")
    step = pm.local_step_fn() if local else pm.step_fn()
    # the stencil object is shared by equal builds: count this call's
    pm.stencil.backend.launches = pm.stencil.backend.repairs = 0
    got = step(t["h"], t["u"], t["v"])
    for g, ref in zip(got, _jax_step(aligned, local, state)):
        assert tuple(g.shape) == pm.field_shape()
        np.testing.assert_allclose(g.numpy(), ref, **TOL)
    for k, v in state.items():
        np.testing.assert_array_equal(t[k].numpy(), v)
    if backend == "cuda":
        plan = cuda_backend.LAST_PLAN[pm.stencil.name]
        assert pm.stencil.backend.launches == 1 and plan["vector"] == 2, plan
        assert "repair" not in plan and pm.stencil.backend.repairs == 0, plan


def test_sw_float32_vector_form_equals_plain(emulated):  # noqa: F811
    """float32 (four J points a thread) on both layouts and both steps:
    the emulated kernels bit for bit against the plain executor."""
    for aligned in (True, False):
        models = {b: ShallowWater(NI, NJ, NK, dtype=np.float32, backend=b, aligned=aligned,
                                  device="cpu") for b in ("cuda", "torch")}
        state = models["torch"].init_state()
        state["u"] = torch.from_numpy(
            np.random.default_rng(2).random(state["u"].shape).astype(np.float32))
        for local in (False, True):
            got = {b: (m.local_step_fn() if local else m.step_fn())(*(state[k] for k in "huv"))
                   for b, m in models.items()}
            plan = cuda_backend.LAST_PLAN[models["cuda"].stencil.name]
            assert plan["vector"] == 4 and "repair" not in plan, plan
            for a, b in zip(got["cuda"], got["torch"]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sw_step_vs_numpy_oracle(request, backend):
    """The periodic step equals the JAX package's numpy oracle on the
    interior, and the port's plain oracle equals it too."""
    _port(request, backend)
    jn = j_sw.ShallowWater(NI, NJ, NK, dtype=np.float64, backend="numpy")
    pm = ShallowWater(NI, NJ, NK, dtype=np.float64, backend=backend, device="cpu")
    state = j_sw.ShallowWater(NI, NJ, NK, dtype=np.float64, backend="jax").init_state(seed=2)
    state["u"] = np.random.default_rng(3).random(state["u"].shape)
    oi, oj = pm.oi, pm.oj
    win = (slice(None), slice(oi - HW, oi + NI + HW), slice(oj - HW, oj + NJ + HW))
    L = {k: np.transpose(v[win], (1, 2, 0)).copy() for k, v in state.items()}
    ref = jn.run_numpy_oracle(L["h"], L["u"], L["v"])
    t = state_from_numpy(state, "cpu")
    got = pm.step_fn()(t["h"], t["u"], t["v"])
    mine = pm.run_plain_oracle(*(torch.from_numpy(L[k]) for k in "huv"))
    for g, m, r in zip(got, mine, ref):
        g = np.transpose(g.numpy(), (1, 2, 0))[oi:oi + NI, oj:oj + NJ]
        np.testing.assert_allclose(g, r[HW:HW + NI, HW:HW + NJ], **TOL)
        np.testing.assert_allclose(m.numpy()[HW:HW + NI, HW:HW + NJ],
                                   r[HW:HW + NI, HW:HW + NJ], **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sw_conserves_mass(request, backend):
    _port(request, backend)
    m = ShallowWater(NI, NJ, NK, dtype=np.float64, backend=backend, device="cpu")
    s = m.init_state(seed=2)
    step = m.step_fn()
    h, u, v = s["h"], s["u"], s["v"]
    interior = (slice(None), slice(m.oi, m.oi + NI), slice(m.oj, m.oj + NJ))
    total0 = float(h[interior].sum())
    for _ in range(20):
        h, u, v = step(h, u, v)
    assert abs(float(h[interior].sum()) - total0) < 1e-12 * abs(total0)
    assert float(u[interior].abs().max()) > 0


def test_sw_init_state_is_the_jax_models_draw():
    for aligned in (True, False):
        ref = j_sw.ShallowWater(NI, NJ, NK, dtype=np.float32, aligned=aligned).init_state()
        got = ShallowWater(NI, NJ, NK, dtype=np.float32, aligned=aligned,
                           device="cpu").init_state()
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spectral_vs_jax_and_numpy(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    q = rng.random((3, 16, 20)).astype(dtype)
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    atol = 1e-12 if dtype == np.float64 else 1e-6
    for name, args in (("spectral_filter", (1.0,)), ("poisson_solve", ())):
        got = getattr(spectral, name)(torch.from_numpy(q), *args)
        assert got.dtype == torch.from_numpy(q).dtype
        ref_np = getattr(j_spec, name + "_numpy")(q, *args)
        mine_np = getattr(spectral, name + "_numpy")(q, *args)
        np.testing.assert_array_equal(mine_np, ref_np)
        ref_jax = np.asarray(getattr(j_spec, name)(jnp.asarray(q), *args))
        np.testing.assert_allclose(got.numpy(), ref_np, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got.numpy(), ref_jax, rtol=rtol, atol=atol)


def test_poisson_solve_inverts_the_spectral_laplacian():
    rng = np.random.default_rng(3)
    rhs = rng.random((4, 16, 12))
    rhs -= rhs.mean(axis=(1, 2), keepdims=True)
    smooth = spectral.spectral_filter(torch.from_numpy(rhs), 0.8)
    p = spectral.poisson_solve(smooth).numpy()
    kx = np.fft.fftfreq(16) * 2 * np.pi
    ky = np.fft.rfftfreq(12) * 2 * np.pi
    k2 = kx.reshape(1, -1, 1) ** 2 + ky.reshape(1, 1, -1) ** 2
    lap = np.fft.irfft2(np.fft.rfft2(p, axes=(1, 2)) * (-k2), s=(16, 12), axes=(1, 2))
    np.testing.assert_allclose(lap, smooth.numpy(), rtol=1e-8, atol=1e-10)
