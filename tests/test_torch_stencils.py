"""The port's stencils against ``gt4py_tpu``: hdiff, vadv, vadv_update and
dycore_fused, periodic and not, on the port's ``"torch"`` and ``"cuda"``
backends (``"cuda"`` runs the plain executor on CPU tensors).

- Against the numpy oracle in float64 at rtol 1e-12 / atol 1e-12.  The
  port is called as the models call it, with one buffer under two names
  (``in_field=u, out_field=u``); the oracle gets a separate copy per name.
- Against the ``"pallas"`` backend in interpret mode in float32 at
  16x128x8, with TPU planning forced on as the JAX package's own tests run
  it.  Tolerance rtol 1e-5 / atol 1e-6: the kernels evaluate the same
  expressions in another operation order (XLA and Mosaic reassociate and
  fuse), so float32 results differ by a few ulp.
- Every canonical stencil of ``tests/cartesian/stencil_defs.py`` on the
  port's ``"torch"`` and ``"cuda"`` backends against the oracle.
"""

import numpy as np
import pytest
import torch

from gt4py_tpu import config as j_config
from gt4py_tpu.cartesian import gtscript as jgts
from gt4py_tpu.models import dycore as j_dycore

from gt4py_tpu_torch import testing as p_testing
from gt4py_tpu_torch.cartesian import gtscript as pgts
from gt4py_tpu_torch.models import dycore as p_dycore

from .cartesian import stencil_defs
from .test_torch_frontend import to_port
from gt4py_tpu_torch import config


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


H = 3
DOMAIN = (10, 12, 6)
SHAPE = (DOMAIN[2], DOMAIN[0] + 2 * H, DOMAIN[1] + 2 * H)  # physical (K, I, J)
ORIGIN = (H, H, 0)

#: stencil -> the arguments of its call in the models; equal values
#: name one buffer (the aliasing the models use)
CALLS = {
    "make_hdiff": dict(in_field="u", out_field="u", coeff="coeff"),
    "make_vadv": dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="x",
                      utens="utens"),
    "make_vadv_update": dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="x",
                             utens="utens", u_out="u"),
    "make_dycore_fused": dict(u="u", coeff="coeff", wcon="wcon", utens="utens",
                              utens_stage="utens_stage", u_out="u"),
}
SCALARS = {"make_hdiff": {}}


def _buffers(dtype, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    scale = {"coeff": 0.025, "wcon": 0.2, "utens": 0.01}
    return {n: (scale.get(n, 1.0) * rng.random(shape)).astype(dtype)
            for n in ("u", "coeff", "wcon", "utens", "utens_stage", "x")}


def _scalars(factory):
    return SCALARS.get(factory, {"dtr_stage": 3.0})


def _oracle(factory, bufs, periodic):
    st = getattr(j_dycore, factory)(np.float64, backend="numpy")
    arrays = {arg: np.ascontiguousarray(bufs[b].transpose(1, 2, 0))
              for arg, b in CALLS[factory].items()}
    st(**arrays, **_scalars(factory), origin=ORIGIN, domain=DOMAIN, periodic=periodic)
    return arrays


def _port(factory, backend, bufs, periodic):
    st = getattr(p_dycore, factory)(np.float64, backend=backend)
    tensors = {b: torch.from_numpy(v.copy()) for b, v in bufs.items()}
    before = {b: t.clone() for b, t in tensors.items()}
    fn = st.functional(origin=ORIGIN, domain=DOMAIN, physical_layout=True, periodic=periodic)
    outs = fn(**{arg: tensors[b] for arg, b in CALLS[factory].items()}, **_scalars(factory))
    for b, t in tensors.items():  # the arguments are left unchanged
        assert torch.equal(t, before[b]), b
    return outs


@pytest.mark.parametrize("periodic", [(), ("I", "J")], ids=["plain", "periodic"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("factory", list(CALLS))
def test_dycore_stencil_vs_numpy_oracle(factory, backend, periodic):
    bufs = _buffers(np.float64, seed=7)
    ref = _oracle(factory, bufs, periodic)
    outs = _port(factory, backend, bufs, periodic)
    written = [n for n, i in getattr(p_dycore, factory)(np.float64, backend=backend)
               .field_info.items() if i.access.value & 2]
    assert sorted(outs) == sorted(written)
    for name, t in outs.items():
        np.testing.assert_allclose(t.numpy().transpose(1, 2, 0), ref[name],
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_periodic_wrap_reads_the_opposite_edge():
    """hdiff on a periodic field equals hdiff on a copy whose halos were
    filled from the opposite interior edge (corners wrapped on both axes)."""
    bufs = _buffers(np.float64, seed=11)
    st = p_dycore.make_hdiff(np.float64, backend="cuda")
    kw = dict(origin=ORIGIN, domain=DOMAIN, physical_layout=True)
    u = torch.from_numpy(bufs["u"])
    coeff = torch.from_numpy(bufs["coeff"])
    wrapped = st.functional(**kw, periodic=("I", "J"))(in_field=u, out_field=u, coeff=coeff)
    filled = p_dycore.periodic_fill(u.clone(), H, DOMAIN[0], DOMAIN[1])
    ref = st.functional(**kw)(in_field=filled, out_field=u, coeff=coeff)
    torch.testing.assert_close(wrapped["out_field"], ref["out_field"], rtol=0, atol=0)


def test_periodic_domain_smaller_than_halo_raises():
    st = p_dycore.make_hdiff(np.float64, backend="cuda")
    t = torch.zeros((4, 1 + 2 * H, 8 + 2 * H), dtype=torch.float64)
    fn = st.functional(origin=ORIGIN, domain=(1, 8, 4), physical_layout=True, periodic="IJ")
    with pytest.raises(ValueError, match="smaller than the read halo"):
        fn(in_field=t, out_field=t, coeff=t)


# --------------------------------------------------------------------- #
# against the pallas kernels (interpret mode, TPU planning)
# --------------------------------------------------------------------- #


def _pallas_outputs(jmd, fns, state):
    import jax.numpy as jnp

    st = {k: jnp.asarray(v) for k, v in state.items()}
    x = st["u"] * 0.5
    calls = {
        "hdiff": (fns[0], dict(in_field=st["u"], out_field=st["u"], coeff=st["coeff"])),
        "vadv_update": (fns[1], dict(utens_stage=st["utens_stage"], u_stage=x,
                                     wcon=st["wcon"], u_pos=x, utens=st["utens"],
                                     u_out=st["u"], dtr_stage=jnp.asarray(3.0, jnp.float32))),
        "dycore_fused": (fns[2], dict(u=st["u"], coeff=st["coeff"], wcon=st["wcon"],
                                      utens=st["utens"], utens_stage=st["utens_stage"],
                                      u_out=st["u"], dtr_stage=jnp.asarray(3.0, jnp.float32))),
    }
    return {k: {n: np.asarray(v) for n, v in fn(**kw).items()} for k, (fn, kw) in calls.items()}


def _port_outputs(pmd, fns, state):
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    x = st["u"] * 0.5
    calls = {
        "hdiff": (fns[0], dict(in_field=st["u"], out_field=st["u"], coeff=st["coeff"])),
        "vadv_update": (fns[1], dict(utens_stage=st["utens_stage"], u_stage=x,
                                     wcon=st["wcon"], u_pos=x, utens=st["utens"],
                                     u_out=st["u"], dtr_stage=3.0)),
        "dycore_fused": (fns[2], dict(u=st["u"], coeff=st["coeff"], wcon=st["wcon"],
                                      utens=st["utens"], utens_stage=st["utens_stage"],
                                      u_out=st["u"], dtr_stage=3.0)),
    }
    return {k: {n: v.numpy() for n, v in fn(**kw).items()} for k, (fn, kw) in calls.items()}


@pytest.mark.parametrize("periodic", [False, True], ids=["plain", "periodic"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_dycore_stencils_vs_pallas_interpret(monkeypatch, backend, periodic):
    monkeypatch.setattr(j_config, "ASSUME_TPU_PLANNING", True)
    ni, nj, nk = 16, 128, 8
    jmd = j_dycore.MiniDycore(ni, nj, nk, dtype=np.float32, backend="pallas", aligned=True)
    pmd = p_dycore.MiniDycore(ni, nj, nk, dtype=np.float32, backend=backend, aligned=True)
    sfx = "_p" if periodic else ""
    state = jmd.init_state(seed=5)
    got = _port_outputs(pmd, [getattr(pmd, n + sfx) for n in
                              ("hdiff_fn", "vadv_upd_fn", "fused_fn")], state)
    ref = _pallas_outputs(jmd, [getattr(jmd, n + sfx) for n in
                                ("hdiff_fn", "vadv_upd_fn", "fused_fn")], state)
    for stencil, outs in ref.items():
        assert sorted(got[stencil]) == sorted(outs)
        for name, v in outs.items():
            # operation order differs between the kernels: a few f32 ulp
            np.testing.assert_allclose(got[stencil][name], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{stencil}.{name}")


# --------------------------------------------------------------------- #
# the canonical stencil definitions on the port's plain executor
# --------------------------------------------------------------------- #


def _run_defs(gts, definition, entry, backend):
    st = gts.stencil(backend=backend, definition=definition,
                     externals=entry["externals"], rebuild=True)
    inputs = entry["make_inputs"]()
    fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    kwargs = {}
    if entry["origin"] is not None:
        kwargs["origin"] = entry["origin"]
    if entry["domain"] is not None:
        kwargs["domain"] = entry["domain"]
    st(**fields, **scalars, **kwargs)
    return fields


@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_stencil_defs_torch_vs_numpy_oracle(name):
    entry = stencil_defs.REGISTRY[name]
    ref = _run_defs(jgts, entry["definition"], entry, "numpy")
    got = _run_defs(pgts, to_port(entry["definition"]), entry, "torch")
    for f in ref:
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name}.{f}")


#: canonical stencils outside the CUDA emitters' subset, and the node the
#: build names: none (``while``, regions, variable K and data dimensions
#: have emitters)
CUDA_UNSUPPORTED = {}


@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_stencil_defs_cuda_backend_builds_or_names_the_node(name):
    """Each canonical stencil either builds under "cuda" (and then runs the
    plain executor on CPU arrays, matching the oracle) or raises
    NotImplementedError naming the IR node the emitters lack."""
    entry = stencil_defs.REGISTRY[name]
    if name in CUDA_UNSUPPORTED:
        with pytest.raises(NotImplementedError, match=CUDA_UNSUPPORTED[name]):
            pgts.stencil(backend="cuda", definition=to_port(entry["definition"]),
                         externals=entry["externals"], rebuild=True)
        return
    ref = _run_defs(jgts, entry["definition"], entry, "numpy")
    got = _run_defs(pgts, to_port(entry["definition"]), entry, "cuda")
    for f in ref:
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name}.{f}")



def test_port_registry_loads_every_canonical_stencil():
    """``gt4py_tpu_torch.testing`` loads tests/cartesian/stencil_defs.py onto
    the port (for the card, where JAX is absent): the same entries, each
    definition built by the port's frontend with the same analysis."""
    from .test_torch_frontend import assert_same_analysis

    port = p_testing.load_stencil_defs()
    assert sorted(port) == sorted(stencil_defs.REGISTRY)
    for name in ("horizontal_regions", "variable_k_offset", "data_dims_dynamic_index"):
        ja = jgts.stencil(backend="numpy", definition=stencil_defs.REGISTRY[name]["definition"],
                          rebuild=True).analysis
        pa = pgts.stencil(backend="cuda", definition=port[name]["definition"],
                          rebuild=True).analysis
        assert_same_analysis(ja, pa)


@pytest.mark.parametrize("name", sorted(p_testing.SURFACE))
def test_surface_cases_on_cpu_tensors_run_the_plain_executor(name):
    """On CPU tensors the "cuda" backend runs the plain executor: no kernel
    is launched, and the result equals ``"torch"``'s."""
    got, ref, st = p_testing.run_pair(*p_testing.SURFACE[name], "cpu")
    assert st.backend.launches == 0
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_float64_to_float16_rounds_once_as_numpy():
    """``dtypes.cast`` (the plain executor's and the next DSL's casts)
    rounds float64 to float16 once, as numpy does, where ``.half()``
    rounds through float32; ties, overflow, subnormals, inf and nan
    included."""
    from gt4py_tpu_torch.core import dtypes

    rng = np.random.default_rng(0)
    halves = np.float16(rng.normal(0, 10, 20000)).astype(np.float64)
    x = np.concatenate([rng.normal(0, 100, 20000), rng.normal(0, 1e-6, 20000),
                        halves * (1 + 2.0 ** -11), halves * (1 + 2.0 ** -11 + 2.0 ** -40),
                        [1e300, -1e300, np.inf, -np.inf, np.nan, 0.0, -0.0, 65519.99, 65520.0,
                         2.0 ** -25, 2.0 ** -25 * (1 + 1e-9)]])
    with np.errstate(over="ignore"):
        ref = x.astype(np.float16)
    got = dtypes.cast(torch.from_numpy(x), np.float16).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (torch.from_numpy(x).half().numpy() != ref).sum() > 0  # the case that needs it
