"""The port's FvAdvection, semi-Lagrangian stencil and FullDycore against
``gt4py_tpu``'s, on the CPU.

- FvAdvection on ``"torch"`` and ``"cuda"`` (the plain executor on CPU
  tensors) against the JAX model on ``"jax"`` and against its numpy-oracle
  staging, float64 at rtol 1e-12 / atol 1e-12; mass conservation,
  constant preservation and no overshoot as tests/models/test_models.py
  checks them for the JAX model.
- The semi-Lagrangian stencil against ``semi_lagrangian_step_numpy`` at
  rtol 1e-12 / atol 1e-12, and the plain torch steps against it.
- FullDycore against the JAX model on ``"jax"`` in float64 at rtol 1e-12 /
  atol 1e-12, and in float32 against ``"pallas"`` in interpret mode with TPU
  planning forced on, at rtol 1e-5 / atol 1e-6: the kernels evaluate the
  same expressions in another operation order, so float32 results differ
  by a few ulp (measured: 7.2e-7 at most after one step).
- Inputs come from the JAX models' numpy draws through ``state_from_numpy``.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu import config as j_config
from gt4py_tpu.models import full_dycore as j_full
from gt4py_tpu.models import fv_advection as j_fv
from gt4py_tpu.models import semi_lagrangian as j_sl

from gt4py_tpu_torch.models import full_dycore as p_full
from gt4py_tpu_torch.models import fv_advection as p_fv
from gt4py_tpu_torch.models import semi_lagrangian as p_sl
from gt4py_tpu_torch.models.dycore import periodic_fill, state_from_numpy

from .test_torch_frontend import assert_same_analysis
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


NI, NJ, NK = 16, 12, 4
H = p_fv.FvAdvection.HALO
TOL = dict(rtol=1e-12, atol=1e-12)


def _jax_fv_step(aligned, state, steps=1, local=False):
    import jax.numpy as jnp

    jm = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=aligned)
    step = jm.local_step_fn() if local else jm.step_fn()
    q = jnp.asarray(state["q"])
    for _ in range(steps):
        q = step(q, jnp.asarray(state["cx"]), jnp.asarray(state["cy"]))
    return np.asarray(q)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fv_step_vs_jax(backend, aligned):
    jm = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=aligned)
    state = jm.init_state(seed=1)
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend=backend, aligned=aligned,
                          device="cpu")
    t = state_from_numpy(state, "cpu")
    step = pm.step_fn()
    q = t["q"]
    for _ in range(3):
        q = step(q, t["cx"], t["cy"])
    assert tuple(q.shape) == pm.field_shape()
    np.testing.assert_allclose(q.numpy(), _jax_fv_step(aligned, state, steps=3), **TOL)
    for k, v in state.items():  # the step leaves its inputs unchanged
        np.testing.assert_array_equal(t[k].numpy(), v)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fv_local_step_vs_jax(backend):
    """The non-periodic step on halo-prefilled buffers (the halo-exchange
    path): winds and q filled periodically by the caller."""
    jm = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=False)
    state = jm.init_state(seed=4)
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend=backend, aligned=False,
                          device="cpu")
    t = state_from_numpy(state, "cpu")
    cx, cy = pm.fill_winds(t["cx"].clone(), t["cy"].clone())
    q = periodic_fill(t["q"].clone(), H, NI, NJ)
    got = pm.local_step_fn()(q, cx, cy)
    filled = {"q": q.numpy(), "cx": cx.numpy(), "cy": cy.numpy()}
    np.testing.assert_allclose(got.numpy(), _jax_fv_step(False, filled, local=True), **TOL)


def _oracle_window(model, state):
    """Tight logical (I, J, K) arrays at origin (h, h) cut from a physical
    state, the layout ``run_numpy_oracle`` takes."""
    oi, oj = model.oi, model.oj
    win = (slice(None), slice(oi - H, oi + NI + H), slice(oj - H, oj + NJ + H))
    return {k: np.transpose(np.asarray(v)[win], (1, 2, 0)).copy() for k, v in state.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fv_step_vs_numpy_oracle(backend):
    """One fused step equals the JAX package's six-stencil oracle staging,
    and the port's own oracle staging equals the JAX package's."""
    j_np = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="numpy")
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend=backend, device="cpu")
    state = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="jax").init_state(seed=2)
    L = _oracle_window(pm, state)
    ref = j_np.run_numpy_oracle(L["q"], L["cx"], L["cy"])
    t = state_from_numpy(state, "cpu")
    got = pm.step_fn()(t["q"], t["cx"], t["cy"]).numpy()
    oi, oj = pm.oi, pm.oj
    np.testing.assert_allclose(np.transpose(got, (1, 2, 0))[oi:oi + NI, oj:oj + NJ],
                               ref[H:H + NI, H:H + NJ], **TOL)
    mine = pm.run_numpy_oracle(L["q"], L["cx"], L["cy"])
    np.testing.assert_allclose(mine[H:H + NI, H:H + NJ], ref[H:H + NI, H:H + NJ], **TOL)


def _interior(model, a):
    return a[:, model.oi:model.oi + NI, model.oj:model.oj + NJ]


def test_fv_conserves_mass():
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="cuda", device="cpu")
    t = pm.init_state(seed=2)
    step = pm.step_fn()
    q = t["q"]
    total0 = float(_interior(pm, q).sum())
    for _ in range(5):
        q = step(q, t["cx"], t["cy"])
    assert abs(float(_interior(pm, q).sum()) - total0) < 1e-9 * abs(total0)


def test_fv_preserves_constant():
    """Flux-form transport preserves constants for non-divergent winds."""
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="cuda", device="cpu")
    shape = pm.field_shape()
    out = pm.step_fn()(torch.full(shape, 2.5, dtype=torch.float64),
                       torch.full(shape, 0.37, dtype=torch.float64),
                       torch.full(shape, -0.21, dtype=torch.float64))
    np.testing.assert_allclose(_interior(pm, out).numpy(), 2.5, rtol=1e-13)


def test_fv_monotone_no_overshoot():
    """A step function advected with a uniform wind does not overshoot
    beyond the 2D split's small cross-term oscillations."""
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float64, backend="cuda", device="cpu")
    shape = pm.field_shape()
    q = torch.zeros(shape, dtype=torch.float64)
    q[:, H + 4:H + 10, H + 4:H + 10] = 1.0
    cx = torch.full(shape, 0.3, dtype=torch.float64)
    cy = torch.full(shape, 0.2, dtype=torch.float64)
    step = pm.step_fn()
    for _ in range(10):
        q = step(q, cx, cy)
    interior = _interior(pm, q)
    assert float(interior.min()) >= -0.05
    assert float(interior.max()) <= 1.05


def test_fv_init_state_is_the_jax_models_draw():
    pm = p_fv.FvAdvection(NI, NJ, NK, dtype=np.float32, device="cpu")
    ref = j_fv.FvAdvection(NI, NJ, NK, dtype=np.float32, backend="jax").init_state(seed=7)
    got = pm.init_state(seed=7)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


FV_FACTORIES = ["make_xflux", "make_yflux", "make_x_advect", "make_y_advect",
                "make_xy_advect", "make_fv_step", "make_fv_final", "make_flux_update_x",
                "make_flux_update_y"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("factory", FV_FACTORIES)
def test_fv_stencils_same_analysis(factory, dtype):
    ja = getattr(j_fv, factory)(dtype, backend="numpy").analysis
    pa = getattr(p_fv, factory)(dtype, backend="torch").analysis
    assert_same_analysis(ja, pa)


# --------------------------------------------------------------------- #
# semi-Lagrangian
# --------------------------------------------------------------------- #


def _sl_inputs(seed=1, scale=0.4):
    rng = np.random.default_rng(seed)
    shape = (NK, NI, NJ)
    return (rng.random(shape), scale * (rng.random(shape) - 0.5) * 2,
            scale * (rng.random(shape) - 0.5) * 2)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sl_stencil_vs_numpy(backend):
    """The windowed stencil on a halo buffer with periodic wrap equals the
    numpy oracle on the interior (displacements within one cell)."""
    q, u, v = _sl_inputs(seed=3, scale=0.9)
    st = p_sl.make_sl_stencil(np.float64, backend=backend, max_shift=1)
    fn = st.functional(origin=(H, H, 0), domain=(NI, NJ, NK), physical_layout=True,
                       periodic=("I", "J"))

    def halo(a):
        return torch.from_numpy(np.pad(a, ((0, 0), (H, H), (H, H))))

    out = fn(q=halo(q), u=halo(u), v=halo(v), qout=torch.zeros((NK, NI + 2 * H, NJ + 2 * H),
                                                                 dtype=torch.float64),
             dtdx=0.7, dtdy=0.7)["qout"]
    ref = j_sl.semi_lagrangian_step_numpy(q, u, v, dt=0.7)
    np.testing.assert_allclose(out.numpy()[:, H:H + NI, H:H + NJ], ref, **TOL)
    np.testing.assert_allclose(p_sl.semi_lagrangian_step_numpy(q, u, v, dt=0.7), ref,
                               rtol=0, atol=0)


@pytest.mark.parametrize("max_shift", [None, 1])
def test_sl_torch_steps_vs_numpy(max_shift):
    q, u, v = _sl_inputs(seed=5, scale=1.0)
    out = p_sl.semi_lagrangian_step(torch.from_numpy(q), torch.from_numpy(u),
                                    torch.from_numpy(v), dt=0.7, max_shift=max_shift)
    ref = j_sl.semi_lagrangian_step_numpy(q, u, v, dt=0.7)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_sl_integer_shift_exact():
    rng = np.random.default_rng(0)
    q = rng.random((NK, NI, NJ))
    u = np.full((NK, NI, NJ), 3.0)
    v = np.full((NK, NI, NJ), -2.0)
    out = p_sl.semi_lagrangian_step(torch.from_numpy(q), torch.from_numpy(u),
                                    torch.from_numpy(v), dt=1.0)
    np.testing.assert_allclose(out.numpy(), np.roll(np.roll(q, 3, axis=1), -2, axis=2), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sl_stencil_same_analysis(dtype):
    ja = j_sl.make_sl_stencil(dtype, backend="numpy").analysis
    pa = p_sl.make_sl_stencil(dtype, backend="torch").analysis
    assert_same_analysis(ja, pa)


# --------------------------------------------------------------------- #
# FullDycore
# --------------------------------------------------------------------- #


def _jax_full(dtype, backend, aligned, seed, steps, ni=NI, nj=NJ, nk=NK):
    import jax.numpy as jnp

    jm = j_full.FullDycore(ni, nj, nk, dtype=dtype, backend=backend, aligned=aligned)
    state = jm.init_state(seed=seed)
    s = {k: jnp.asarray(v) for k, v in state.items()}
    step = jm.step_fn()
    for _ in range(steps):
        s = step(s)
    return state, {k: np.asarray(v) for k, v in s.items()}


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_full_dycore_vs_jax(backend, aligned):
    state, ref = _jax_full(np.float64, "jax", aligned, seed=3, steps=2)
    pm = p_full.FullDycore(NI, NJ, NK, dtype=np.float64, backend=backend, aligned=aligned,
                           device="cpu")
    s = state_from_numpy(state, "cpu")
    step = pm.step_fn()
    for _ in range(2):
        s = step(s)
    assert sorted(s) == sorted(ref)
    for k, v in ref.items():
        assert tuple(s[k].shape) == pm.field_shape() == v.shape
        np.testing.assert_allclose(s[k].numpy(), v, err_msg=k, **TOL)


def test_full_dycore_init_state_is_the_jax_models_draw():
    ref = j_full.FullDycore(NI, NJ, NK, dtype=np.float32, backend="jax").init_state(seed=6)
    got = p_full.FullDycore(NI, NJ, NK, dtype=np.float32, device="cpu").init_state(seed=6)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_full_dycore_f32_vs_pallas_interpret(monkeypatch, backend):
    monkeypatch.setattr(j_config, "ASSUME_TPU_PLANNING", True)
    ni, nj, nk = 16, 128, 8
    state, ref = _jax_full(np.float32, "pallas", True, seed=5, steps=1, ni=ni, nj=nj, nk=nk)
    pm = p_full.FullDycore(ni, nj, nk, dtype=np.float32, backend=backend, device="cpu")
    got = pm.step_fn()(state_from_numpy(state, "cpu"))
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        # operation order differs between the kernels: a few f32 ulp
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
