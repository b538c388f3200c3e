"""The port's MiniDycore against ``gt4py_tpu``'s, and its call-time
checks.

A 3-step run in float64 (aligned and tight origins, the fused and the
two-stencil step) on the port's ``"torch"`` and ``"cuda"`` backends (the
plain executor on CPU tensors) matches ``gt4py_tpu``'s MiniDycore on
``"jax"`` at rtol 1e-12 / atol 1e-12.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu.models import dycore as j_dycore

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian.stencil_object import ArgumentError
from gt4py_tpu_torch.models import dycore as p_dycore
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


NI, NJ, NK = 12, 10, 6


def _run_jax(aligned, fused, steps):
    import jax.numpy as jnp

    md = j_dycore.MiniDycore(NI, NJ, NK, dtype=np.float64, backend="jax", aligned=aligned)
    state = {k: jnp.asarray(v) for k, v in md.init_state(seed=2).items()}
    step = md.step_fn(fused=fused)
    for _ in range(steps):
        state = step(state)
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["two_stencil", "fused"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "tight"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_three_steps_vs_jax(backend, aligned, fused):
    md = p_dycore.MiniDycore(NI, NJ, NK, dtype=np.float64, backend=backend,
                             aligned=aligned, device="cpu")
    state = md.init_state(seed=2)
    step = md.step_fn(fused=fused)
    for _ in range(3):
        state = step(state)
    ref = _run_jax(aligned, fused, 3)
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert tuple(state[k].shape) == md.field_shape() == v.shape
        np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-12, atol=1e-12, err_msg=k)


def test_init_state_is_the_jax_models_draw():
    md = p_dycore.MiniDycore(NI, NJ, NK, dtype=np.float32)
    jmd = j_dycore.MiniDycore(NI, NJ, NK, dtype=np.float32, backend="jax")
    got, ref = md.init_state(seed=9), jmd.init_state(seed=9)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].device == md.device
        np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_state_from_numpy_round_trips(dtype):
    jmd = j_dycore.MiniDycore(NI, NJ, NK, dtype=dtype, backend="jax", aligned=False)
    state = jmd.init_state(seed=4)
    tensors = p_dycore.state_from_numpy(state, device="cpu")
    for k, v in state.items():
        assert tuple(tensors[k].shape) == v.shape  # physical (K, I, J), no transpose
        assert tensors[k].is_contiguous()
        back = tensors[k].numpy()
        assert back.dtype == v.dtype
        np.testing.assert_array_equal(back, v)


def test_fused_equals_two_stencil_step():
    md = p_dycore.MiniDycore(NI, NJ, NK, dtype=np.float64, backend="cuda", aligned=False)
    s = md.init_state(seed=1)
    a, b = md.step_fn()(s), md.step_fn(fused=True)(s)
    for k in ("u", "utens_stage"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-13, atol=1e-13)


def test_step_leaves_its_input_unchanged():
    md = p_dycore.MiniDycore(NI, NJ, NK, dtype=np.float64, backend="cuda", aligned=False)
    s = md.init_state(seed=1)
    before = {k: v.clone() for k, v in s.items()}
    out = md.step_fn()(s)
    for k, v in s.items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(out["u"], s["u"])


def test_periodic_fill_wraps_corners():
    # domain 4 x 5 at origin (2, 2): buffer index x holds interior
    # index 2 + (x - 2) mod n on each axis
    a = torch.arange(2 * 8 * 9, dtype=torch.float64).reshape(2, 8, 9)
    p_dycore.periodic_fill(a, 2, 4, 5)
    np.testing.assert_array_equal(a[:, 0, 0].numpy(), a[:, 4, 5].numpy())
    np.testing.assert_array_equal(a[:, 7, 8].numpy(), a[:, 3, 3].numpy())
    np.testing.assert_array_equal(a[:, 0, 4].numpy(), a[:, 4, 4].numpy())


# --------------------------------------------------------------------- #
# call-time checks
# --------------------------------------------------------------------- #


def _hdiff_fn(backend="cuda"):
    st = p_dycore.make_hdiff(np.float64, backend=backend)
    return st, st.functional(origin=(3, 3, 0), domain=(NI, NJ, NK), physical_layout=True)


def _field(dtype=torch.float64, halo=3):
    g = torch.Generator().manual_seed(0)
    return torch.rand((NK, NI + 2 * halo, NJ + 2 * halo), generator=g, dtype=dtype)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_wrong_dtype_raises(backend):
    _, fn = _hdiff_fn(backend)
    u = _field()
    with pytest.raises(ArgumentError, match="dtype"):
        fn(in_field=u, out_field=u, coeff=_field(torch.float32))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_too_small_halo_raises(backend):
    st = p_dycore.make_hdiff(np.float64, backend=backend)
    fn = st.functional(origin=(1, 1, 0), domain=(NI, NJ, NK), physical_layout=True)
    u = _field(halo=1)
    with pytest.raises(ArgumentError, match="halo"):
        fn(in_field=u, out_field=u, coeff=u)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_missing_argument_raises(backend):
    _, fn = _hdiff_fn(backend)
    u = _field()
    with pytest.raises(ArgumentError, match="Missing argument 'coeff'"):
        fn(in_field=u, out_field=u)


def test_missing_scalar_raises():
    md = p_dycore.MiniDycore(NI, NJ, NK, dtype=np.float64, backend="cuda", aligned=False)
    s = md.init_state(seed=0)
    with pytest.raises(ArgumentError, match="dtr_stage"):
        md.vadv_fn(utens_stage=s["utens_stage"], u_stage=s["u"], wcon=s["wcon"],
                   u_pos=s["u"], utens=s["utens"])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_aliased_read_and_write_buffer(backend):
    """in_field and out_field name one buffer: the result equals the run
    with two separate buffers, and the buffer itself is left unchanged."""
    _, fn = _hdiff_fn(backend)
    u, coeff = _field(), _field() * 0.025
    u0 = u.clone()
    aliased = fn(in_field=u, out_field=u, coeff=coeff)["out_field"]
    separate = fn(in_field=u.clone(), out_field=u.clone(), coeff=coeff)["out_field"]
    assert torch.equal(u, u0)
    assert aliased.data_ptr() != u.data_ptr()
    torch.testing.assert_close(aliased, separate, rtol=0, atol=0)
    # the output is a clone: halos keep the argument's values
    torch.testing.assert_close(aliased[:, :3], u0[:, :3], rtol=0, atol=0)


def test_call_with_field_storage_updates_in_place():
    """The non-functional call writes into the FieldStorage holders."""
    st = p_dycore.make_hdiff(np.float64, backend="cuda")
    rng = np.random.default_rng(0)
    shape = (NI + 6, NJ + 6, NK)
    inp = storage.from_array(rng.random(shape), device="cpu", aligned_index=(3, 3, 0))
    coeff = storage.from_array(0.025 * rng.random(shape), device="cpu", aligned_index=(3, 3, 0))
    out = storage.zeros(shape, device="cpu", aligned_index=(3, 3, 0))
    st(inp, out, coeff)
    ref = p_dycore.make_hdiff(np.float64, backend="torch")
    out2 = storage.zeros(shape, device="cpu", aligned_index=(3, 3, 0))
    ref(inp, out2, coeff)
    assert float(out.data.abs().sum()) > 0
    torch.testing.assert_close(out.data, out2.data, rtol=0, atol=0)


def test_mixed_devices_raise():
    """A CPU field next to a field on another device is refused (the
    meta device stands in for a card here)."""
    _, fn = _hdiff_fn("cuda")
    u = _field()
    with pytest.raises(ArgumentError, match="several devices"):
        fn(in_field=u, out_field=u, coeff=torch.empty_like(u, device="meta"))

