"""K8's derivative stencils for the constructs the gather-form adjoint
once declined: writes at a K offset, writes to a data-dimension component,
lower-dimensional fields written or differentiated, run-time interval
bounds, and variable- or absolute-K reads of a field the stencil writes.

Each definition lives once, as source text built into both packages
(``gt4py_tpu_torch.testing.derivative_constructs``, which the chip check
runs too).  The same seeded numpy inputs go through ``jax.grad`` /
``jax.jvp`` of the JAX package's ``"jax"`` backend and through the port's
``"cuda"`` backend with ``derivative="kernels"`` (the derivative stencils
on the plain executor), at rtol 1e-12 / atol 1e-13 in float64, bounded
and periodic in I and J; one definition of
each construct runs the derivative stencils as the generated kernels
built by the host compiler, and the dot-product identity
<J v, w> = <v, J^T w> holds for each.  The forward kernels hold a
written field that lacks I or J as a copy with both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gt4py_tpu.cartesian import gtscript as j_gtscript

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import derivative, gtscript
from gt4py_tpu_torch.cartesian.backend import autodiff, cuda_backend
from gt4py_tpu_torch.cartesian.backend.torch_backend import wants_derivative
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval
from gt4py_tpu_torch.testing import derivative_constructs

from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


TOL = dict(rtol=1e-12, atol=1e-13)

PORT = derivative_constructs.build("gt4py_tpu_torch")
JAX = derivative_constructs.build("gt4py_tpu")
CASES = derivative_constructs.CASES
DOMAIN = (7, 6, 5)
ORIGIN = derivative_constructs.ORIGIN


def _port_stencil(name, opt="kernels"):
    return gtscript.stencil(backend="cuda", definition=PORT[name], rebuild=True,
                            name=f"{name}_{opt}", derivative=opt)


def _setup(name):
    """The case's fields (numpy, logical (I, J, K, *data)), its scalars,
    domain and origin, the differentiated inputs, the written fields'
    weights (cotangents) and the tangents, from a seed of the name."""
    wrt, scalars = CASES[name]
    seed = sum(map(ord, name))
    fields, weights = derivative_constructs.inputs(_port_stencil(name, None).backend.analysis,
                                                   DOMAIN, seed)
    rng = np.random.default_rng(seed + 1)
    tans = [rng.random(fields[n].shape) for n in wrt]
    return fields, dict(scalars), DOMAIN, ORIGIN, wrt, weights, tans


@functools.lru_cache(maxsize=None)
def _jax_derivatives(name, periodic=()):
    """``jax.grad`` and ``jax.jvp`` of the weighted outputs' sum on the JAX
    package's ``"jax"`` backend."""
    fields, scalars, domain, origin, wrt, weights, tans = _setup(name)
    fn = j_gtscript.stencil(backend="jax", definition=JAX[name], rebuild=True).functional(
        origin=origin, domain=domain, periodic=periodic)

    def loss(*xs):
        args = {**fields, **dict(zip(wrt, xs))}
        outs = fn(**{k: jnp.asarray(v) for k, v in args.items()}, **scalars)
        return sum(jnp.sum(outs[k] * w) for k, w in weights.items())

    xs = [jnp.asarray(fields[k]) for k in wrt]
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*xs)
    _, tang = jax.jit(lambda a, t: jax.jvp(loss, a, t))(
        tuple(xs), tuple(jnp.asarray(t) for t in tans))
    return [np.asarray(g) for g in grads], float(tang)


def _port_derivatives(name, periodic=(), opt="kernels"):
    """The same on the port's ``"cuda"`` backend with ``derivative=opt``:
    the gradients, the tangent, the outputs' tangents (for the dot-product
    identity) and the stencil."""
    fields, scalars, domain, origin, wrt, weights, tans = _setup(name)
    st = _port_stencil(name, opt)
    fn = st.functional(origin=origin, domain=domain, periodic=periodic)
    base = {k: torch.from_numpy(v) for k, v in fields.items()}

    def outputs(*xs):
        return fn(**{**base, **dict(zip(wrt, xs))}, **scalars)

    def loss(*xs):
        outs = outputs(*xs)
        return sum((outs[k] * torch.from_numpy(w)).sum() for k, w in weights.items())

    xs = [base[k] for k in wrt]
    leaves = [x.clone().requires_grad_() for x in xs]
    grads = [g.numpy() for g in torch.autograd.grad(loss(*leaves), leaves)]
    t = tuple(torch.from_numpy(v) for v in tans)
    _, tang = torch.func.jvp(loss, tuple(xs), t)
    _, out_tans = torch.func.jvp(outputs, tuple(xs), t)
    return grads, float(tang), out_tans, st


def _check(name, periodic, grads, tang, st):
    ref_grads, ref_tang = _jax_derivatives(name, periodic)
    for n, g, r in zip(CASES[name][0], grads, ref_grads):
        np.testing.assert_allclose(g, r, **TOL, err_msg=f"{name}: {n}")
    np.testing.assert_allclose(tang, ref_tang, **TOL, err_msg=name)
    plan = cuda_backend.LAST_PLAN[st.backend.analysis.stencil.name]
    assert "stencil" in plan["adjoint"] and "stencil" in plan["tangent"], plan
    assert st.backend.plain_reruns == 0


LEGS = [(name, periodic) for name in CASES for periodic in ((), ("I", "J"))]


@functools.lru_cache(maxsize=None)
def _plain(name, periodic):
    """``_port_derivatives`` on the plain executor, shared by the tests
    that read it."""
    return _port_derivatives(name, periodic)


@pytest.mark.parametrize("name, periodic", LEGS)
def test_constructs_vs_jax(name, periodic):
    """The gradient and the tangent from the derivative stencils, on the
    plain executor, against the JAX package's; the adjoint is a built
    stencil, not a decline."""
    grads, tang, _, st = _plain(name, periodic)
    _check(name, periodic, grads, tang, st)
    assert (st.backend.adjoint_calls, st.backend.tangent_calls) == (1, 2)


@pytest.mark.parametrize("name, periodic", LEGS)
def test_dot_product_identity(name, periodic):
    """<J v, w> from the tangent stencil equals <v, J^T w> from the
    adjoint stencil."""
    grads, _, out_tans, _ = _plain(name, periodic)
    weights, tans = _setup(name)[5:]
    jv_w = sum(float((out_tans[o] * torch.from_numpy(w)).sum()) for o, w in weights.items())
    v_jtw = sum(float(np.vdot(t, g)) for t, g in zip(tans, grads))
    np.testing.assert_allclose(jv_w, v_jtw, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", derivative_constructs.CHIP)
def test_constructs_emulated_vs_jax(emulated, name):  # noqa: F811
    """The forward, the adjoint and the tangent on the emulated kernels:
    each derivative stencil launched once a call, no plain re-run."""
    grads, tang, _, st = _port_derivatives(name)
    _check(name, (), grads, tang, st)
    for kind, backends in st.backend.derivative_backends().items():
        assert [b.launches for b in backends] == [1 if kind == "adjoint" else 2], kind


@pytest.mark.parametrize("name", list(CASES))
def test_no_decline_on_the_card(monkeypatch, name):
    """With the card's default rule (the derivative stencils wherever the
    forward ran the kernels; here their plain version), each definition's
    gradient comes from its adjoint stencil: nothing declines, nothing
    re-runs, and the gradient equals the forced ``derivative="kernels"``
    one."""
    monkeypatch.setattr(autodiff, "_on_kernels", lambda call, tensors: call.kernels is not None)
    plain_apply = cuda_backend.CudaBackend.apply

    def apply(self, env, scalars, domain, origins, periodic=(), frame=None, levels=None,
              outputs=None):
        if not wants_derivative([*env.values(), *scalars.values()]):
            return plain_apply(self, env, scalars, domain, origins, periodic, frame, levels)
        # under K8 as on the card, the forward from the plain executor
        self._k8(self._plain_launch, env, scalars, domain, origins, periodic, outputs)

    monkeypatch.setattr(cuda_backend.CudaBackend, "apply", apply)
    grads, tang, _, st = _port_derivatives(name, opt=None)
    b = st.backend
    assert (b.derivative_declines, b.adjoint_calls, b.plain_reruns) == (0, 1, 0)
    ref, ref_tang, _, _ = _plain(name, ())
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(tang, ref_tang, **TOL)


@pytest.mark.parametrize("periodic", [(), ("I", "J")])
@pytest.mark.parametrize("name", ["i_field_write", "k_field_write", "ik_field_write",
                                  "jk_field_write"])
def test_lower_dim_writes_on_the_kernels(emulated, name, periodic):  # noqa: F811
    """A written field that lacks I or J, which the stencil also reads:
    every thread along the axis it lacks writes the same element, so the
    kernels hold it as a copy with I and J that the launch makes (after
    the periodic fill) and writes back (``CudaBackend.widened``); the
    forward on the emulated kernels equals the plain executor's, bounded
    and periodic (the other fields read at I and J offsets)."""
    fields, scalars, domain, origin, _, _, _ = _setup(name)
    plain = gtscript.stencil(backend="torch", definition=PORT[name], rebuild=True)
    st = _port_stencil(name, None)
    assert st.backend.widened == (CASES[name][0][2],)
    args = {k: torch.from_numpy(v) for k, v in fields.items()}
    before = st.backend.launches
    got = st.functional(origin=origin, domain=domain, periodic=periodic)(**args, **scalars)
    ref = plain.functional(origin=origin, domain=domain, periodic=periodic)(**args, **scalars)
    assert st.backend.launches == before + 1
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)


def _widened_read_at_an_offset(g: gtscript.Field[gtscript.JK, np.float64],
                               f: gtscript.Field[gtscript.JK, np.float64],
                               out: gtscript.Field[np.float64]):
    with computation(PARALLEL), interval(...):
        out = f[1, 0] * g
    with computation(PARALLEL), interval(...):
        f = f * g


def test_written_field_read_at_a_horizontal_offset_is_rejected():
    """A field the stencil writes is never read at an I or J offset (its
    write would reach beyond the domain: a race the validation rejects), so
    no periodic fill changes a widened field's halo, and its copy, made
    after the fill, holds what the plain executor reads."""
    from gt4py_tpu_torch.cartesian.validation import GTScriptValidationError

    with pytest.raises(GTScriptValidationError, match="extended write of API field 'f'"):
        gtscript.stencil(backend="cuda", definition=_widened_read_at_an_offset, rebuild=True)


def test_runtime_bounds_key_the_adjoint():
    """The adjoint of a stencil with run-time interval bounds is built for
    the bounds' values of the call: a new value builds a new adjoint (one
    more build of its sources), the same value reuses it."""
    st = _port_stencil("runtime_interval_scan", "kernels")
    fields, _, domain, origin, _, _, _ = _setup("runtime_interval_scan")
    fn = st.functional(origin=origin, domain=domain)
    a = torch.from_numpy(fields["a"]).requires_grad_()
    out = torch.from_numpy(fields["out"])
    keys = []
    for k1 in (3, 4, 3):
        torch.autograd.grad(fn(a=a, out=out, k1=k1)["out"].sum(), a)
        keys.append(len([k for k in st.backend._derivatives if k[0] == "adjoint"]))
    assert keys[-1] == 2 and keys == sorted(keys)
    ((_, (_, b3)),) = [(k, v) for k, v in st.backend._derivatives.items()
                       if k[0] == "adjoint" and k[-1] == (("k1", 3),)]
    assert b3.analysis.stencil.name.endswith("__adj")


def test_write_at_a_per_point_component_keeps_the_plain_rerun():
    """A write at a per-point data-dimension index is a scatter: it declines
    with ``DYNAMIC_INDEX``, which keeps the plain re-run on the card."""
    from gt4py_tpu_torch import testing
    st = gtscript.stencil(backend="cuda", definition=testing.SURFACE["data_dims_dynamic_write"][0],
                          rebuild=True, derivative="kernels")
    with pytest.raises(derivative.Declined) as e:
        derivative.adjoint_stencil(st.backend.analysis, ["a", "vec"], 4)
    assert str(e.value) == derivative.DYNAMIC_INDEX and e.value.reruns
