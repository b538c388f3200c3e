"""K8's derivative stencils (``cartesian/derivative.py``), held to the JAX
package's derivatives.

The tangent and the adjoint of a stencil are stencils generated from its IR;
with ``derivative="kernels"`` a ``"cuda"`` stencil's backward and jvp run
them on any device: here on the CPU through the plain executor (their plain
version), and as the generated kernels built by the host compiler
(``tests/test_torch_emulated.py``).  The same seeded numpy inputs go through
``jax.grad`` / ``jax.jvp`` of the JAX package's ``"jax"`` backend, and the
gradients and tangents agree at rtol 1e-12 in float64:

- every ``tests/cartesian/stencil_defs.py`` definition the transform covers
  (those it declines keep the plain re-run, each named in ``LAST_PLAN``);
- hdiff, vadv_update and fv_step on the tight layout with halos and on the
  periodic one, the in-place hdiff (``in_field=u, out_field=u``), and the
  dot-product identity <J v, w> = <v, J^T w> of each;
- the MiniDycore(8, 8, 4) and FullDycore(16, 16, 4) step gradients with the
  backward on the emulated derivative kernels;
- the card tests' K8 cases on the emulated kernels, against the plain re-run;
- second order (``torch.func.jvp`` of ``torch.func.grad``, ``grad`` of
  ``grad``, ``create_graph=True``) through the derivative stencils'
  own derivative stencils, against ``jax.hessian``;
- the declines: only ``derivative.PLAIN_RERUN``'s constructs keep the
  plain re-run on the card, every other raises; the derivative's names
  never clash with the stencil's;
- random programs of the differential fuzzer (``testing.program_gen``,
  without ``while``), against autograd through the plain executor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from gt4py_tpu.cartesian import gtscript as j_gtscript
from gt4py_tpu.models import dycore as j_dycore
from gt4py_tpu.models import fv_advection as j_fv

import gt4py_tpu_torch.next as pgtx
from gt4py_tpu_torch import config, testing
from gt4py_tpu_torch.cartesian import derivative, gtscript, ir
from gt4py_tpu_torch.cartesian.gtscript import FORWARD, PARALLEL, computation, interval
from gt4py_tpu_torch.cartesian.backend import autodiff, cuda_backend
from gt4py_tpu_torch.cartesian.backend.torch_backend import TorchBackend
from gt4py_tpu_torch.cartesian.stencil_object import StencilObject
from gt4py_tpu_torch.models import dycore, full_dycore, fv_advection
from gt4py_tpu_torch.models.dycore import state_from_numpy
from gt4py_tpu_torch.next import cuda_bridge
from gt4py_tpu_torch.testing import program_gen

from . import test_torch_next
from .cartesian import stencil_defs
from .test_torch_autodiff import FULL_PROGNOSTIC, jax_dycore_grad, jax_full_grad  # noqa: F401
from .test_torch_cuda import K8_CASES, _buffers
from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


TOL = dict(rtol=1e-12, atol=1e-13)
PORT_DEFS = testing.load_stencil_defs()
#: the definitions the transform declines, and why
DECLINED = {
    "while_halving": derivative.WHILE,
    "while_backward": derivative.WHILE,
    "region_while_interaction": derivative.WHILE,
    "while_data_dims_interaction": derivative.WHILE,
    "variable_k_offset": derivative.VARIABLE_K,
    "data_dims_dynamic_index": derivative.DYNAMIC_INDEX,
    "native_functions_full": derivative.GAMMA,
    "lower_dim_fields": derivative.LOWER_DIM,
}
#: no float output: nothing to differentiate
NO_FLOAT_OUTPUT = {"form_land_mask"}
COVERED = sorted(set(PORT_DEFS) - set(DECLINED) - NO_FLOAT_OUTPUT)
#: covered definitions that also run on the emulated kernels (the build of
#: every source costs a host compile)
EMULATED_DEFS = ["tridiagonal_solver", "runtime_if_nested", "horizontal_regions", "k_intervals",
                 "two_optional_fields", "data_dims_norm", "local_var_nested_conditional"]


# --------------------------------------------------------------------------- #
# the canonical definitions
# --------------------------------------------------------------------------- #


def _entry_setup(name):
    """The entry's inputs, origin and domain, the differentiated inputs
    (float fields and float scalars), the written float fields' weights
    (the cotangents) and the tangents, from fixed seeds."""
    entry = PORT_DEFS[name]
    st = gtscript.stencil(backend="torch", definition=entry["definition"],
                          externals=entry["externals"], rebuild=True)
    inputs = entry["make_inputs"]()
    fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    origin = entry["origin"] or (0, 0, 0)
    domain = entry["domain"]
    if domain is None:
        omap = st._normalize_origin_arg(origin)
        views = {k: torch.from_numpy(v) for k, v in fields.items()}
        domain = st._get_max_domain(views, {k: st._origin3(k, st._field_origin(k, omap, None))
                                            for k in fields})
    wrt = [k for k, v in fields.items() if v.dtype.kind == "f"] + \
        [k for k, v in scalars.items() if isinstance(v, float)]
    rng = np.random.default_rng(17)
    weights = {k: rng.random(v.shape) for k, v in fields.items()
               if st.field_info[k].access.value & 2 and v.dtype.kind == "f"}
    prims = [fields[k] if k in fields else np.float64(scalars[k]) for k in wrt]
    tans = [rng.random(np.shape(p)).astype(np.asarray(p).dtype) for p in prims]
    return entry, fields, scalars, origin, tuple(domain), wrt, weights, prims, tans


@functools.lru_cache(maxsize=None)
def _jax_derivatives(name, periodic=()):
    """``jax.grad`` and ``jax.jvp`` of the weighted outputs' sum on the JAX
    package's ``"jax"`` backend."""
    _, fields, scalars, origin, domain, wrt, weights, prims, tans = _entry_setup(name)
    entry = stencil_defs.REGISTRY[name]
    st = j_gtscript.stencil(backend="jax", definition=entry["definition"],
                            externals=entry["externals"], rebuild=True)
    fn = st.functional(origin=origin, domain=domain, periodic=periodic)

    def outputs(*xs):
        args = {**fields, **scalars, **dict(zip(wrt, xs))}
        args = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in args.items()}
        return fn(**args)

    def loss(*xs):
        outs = outputs(*xs)
        return sum(jnp.sum(outs[k] * w) for k, w in weights.items())

    xs = [jnp.asarray(p) for p in prims]
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*xs)
    _, tang = jax.jit(lambda a, t: jax.jvp(loss, a, t))(
        tuple(xs), tuple(jnp.asarray(t) for t in tans))
    return [np.asarray(g) for g in grads], float(tang)


def _port_derivatives(name, periodic=()):
    """The same on the port's ``"cuda"`` backend with ``derivative=
    "kernels"``; returns the gradients, the tangent and the stencil."""
    entry, fields, scalars, origin, domain, wrt, weights, prims, tans = _entry_setup(name)
    st = gtscript.stencil(backend="cuda", definition=entry["definition"],
                          externals=entry["externals"], rebuild=True, derivative="kernels")
    fn = st.functional(origin=origin, domain=domain, periodic=periodic)
    base = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()}

    def loss(*xs):
        args = {**base, **scalars, **dict(zip(wrt, xs))}
        outs = fn(**args)
        return sum((outs[k] * torch.from_numpy(w)).sum() for k, w in weights.items())

    xs = [torch.tensor(p) for p in prims]
    leaves = [x.clone().requires_grad_() for x in xs]
    grads = torch.autograd.grad(loss(*leaves), leaves, allow_unused=True)
    _, tang = torch.func.jvp(loss, tuple(xs), tuple(torch.from_numpy(np.asarray(t))
                                                    for t in tans))
    grads = [np.zeros(np.shape(p)) if g is None else g.numpy() for g, p in zip(grads, prims)]
    return grads, float(tang), st


def _check_vs_jax(name, st, grads, tang, ref_grads, ref_tang):
    plan = cuda_backend.LAST_PLAN[st.backend.analysis.stencil.name]
    assert "stencil" in plan["adjoint"] and "stencil" in plan["tangent"], plan
    assert st.backend.adjoint_calls == 1 and st.backend.tangent_calls == 1
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)
    np.testing.assert_allclose(tang, ref_tang, **TOL)


@pytest.mark.parametrize("name", COVERED)
def test_defs_vs_jax(name):
    """Every covered canonical definition: gradient and tangent from the
    derivative stencils on the plain executor against the JAX package's."""
    ref_grads, ref_tang = _jax_derivatives(name)
    grads, tang, st = _port_derivatives(name)
    _check_vs_jax(name, st, grads, tang, ref_grads, ref_tang)


#: periodic calls: on the torus (hdiff, the J-offset function) and, where
#: regions break it, bounded on filled copies with the fill's transpose
PERIODIC_DEFS = {"horizontal_diffusion": ("I", "J"), "gtscript_function_offsets": ("J",),
                 "region_data_dims_interaction": ("I", "J"), "horizontal_regions": ("I", "J")}


@pytest.mark.parametrize("name", sorted(PERIODIC_DEFS))
def test_defs_periodic_vs_jax(name):
    """Periodic calls of canonical definitions against the JAX package's."""
    ref_grads, ref_tang = _jax_derivatives(name, PERIODIC_DEFS[name])
    grads, tang, st = _port_derivatives(name, PERIODIC_DEFS[name])
    _check_vs_jax(name, st, grads, tang, ref_grads, ref_tang)
    ((d, _),) = [v for k, v in st.backend._derivatives.items() if k[0] == "adjoint"]
    assert bool(d.fill) == name.startswith(("region", "horizontal_regions"))


@pytest.mark.parametrize("name", EMULATED_DEFS)
def test_defs_emulated_vs_jax(emulated, name):  # noqa: F811
    """The same with the derivative stencils as the generated kernels."""
    ref_grads, ref_tang = _jax_derivatives(name)
    grads, tang, st = _port_derivatives(name)
    _check_vs_jax(name, st, grads, tang, ref_grads, ref_tang)
    for kind, backends in st.backend.derivative_backends().items():
        assert [b.launches for b in backends] == [1], kind


def _declined_grad(entry, fields, scalars, origin, domain, wrt, weights, prims, opt):
    """The stencil and a thunk for the gradient of the entry's weighted
    outputs with ``derivative=opt``."""
    st = gtscript.stencil(backend="cuda", definition=entry["definition"],
                          externals=entry["externals"], rebuild=True, derivative=opt)
    fn = st.functional(origin=origin, domain=domain)
    base = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()}
    leaves = [torch.tensor(p).requires_grad_() for p in prims]
    outs = fn(**{**base, **scalars, **dict(zip(wrt, leaves))})
    loss = sum((outs[k] * torch.from_numpy(w)).sum() for k, w in weights.items())
    return st, lambda: torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_declines_are_named(emulated, monkeypatch, name):  # noqa: F811
    """A declined definition names its reason in ``LAST_PLAN[name]
    ["adjoint"]`` and the backend counts the decline.  With the card's
    default rule (the derivative stencils wherever the forward ran the
    kernels) a construct of ``derivative.PLAIN_RERUN`` keeps the plain
    re-run, whose gradient equals the CPU's bit for bit; any other decline
    raises.  ``derivative="kernels"`` forced raises every decline."""
    entry, fields, scalars, origin, domain, wrt, weights, prims, _ = _entry_setup(name)
    args = (entry, fields, scalars, origin, domain, wrt, weights, prims)
    _, run = _declined_grad(*args, None)
    ref = run()  # CPU tensors: the plain re-run
    monkeypatch.setattr(autodiff, "_on_kernels", lambda call, tensors: call.kernels is not None)
    st, run = _declined_grad(*args, None)
    if DECLINED[name] in derivative.PLAIN_RERUN:
        got = run()
        reruns = 1
        for a, r in zip(got, ref):
            assert (a is None) == (r is None)
            if a is not None:
                assert torch.equal(a, r)
    else:
        with pytest.raises(derivative.Declined, match=DECLINED[name]):
            run()
        reruns = 0
    plan = cuda_backend.LAST_PLAN[st.backend.analysis.stencil.name]
    assert plan["adjoint"]["declined"] == DECLINED[name]
    b = st.backend
    assert (b.derivative_declines, b.adjoint_calls, b.plain_reruns) == (1, 0, reruns)
    _, run = _declined_grad(*args, "kernels")
    with pytest.raises(derivative.Declined, match=DECLINED[name].split(" (")[0]):
        run()


#: every reason the transform declines with, by its name in the module
REASONS = sorted(k for k, v in vars(derivative).items() if k.isupper() and isinstance(v, str))


def test_only_the_listed_constructs_keep_the_plain_rerun():
    """The constructs without a gather-form adjoint -- ``while``, a
    variable-K, absolute-K or dynamic data-index read of a field whose
    gradient is wanted, and ``gamma`` -- are the only reasons that keep the
    plain re-run on the card."""
    assert derivative.PLAIN_RERUN == {derivative.WHILE, derivative.VARIABLE_K,
                                      derivative.ABSOLUTE_K, derivative.DYNAMIC_INDEX,
                                      derivative.GAMMA}
    assert derivative.PLAIN_RERUN < {getattr(derivative, r) for r in REASONS}


@pytest.mark.parametrize("name", REASONS)
def test_each_decline_on_the_card(emulated, monkeypatch, name):  # noqa: F811
    """For every reason the transform declines with, on the card's default
    rule (the derivative stencils wherever the forward ran the kernels):
    the backward and the jvp take the plain re-run only for a reason of
    ``derivative.PLAIN_RERUN``, and raise the decline for any other."""
    reason = getattr(derivative, name)
    monkeypatch.setattr(autodiff, "_on_kernels", lambda call, tensors: call.kernels is not None)

    def declines(*args, **kw):
        raise derivative.Declined(reason)

    monkeypatch.setattr(derivative, "adjoint_stencil", declines)
    monkeypatch.setattr(derivative, "tangent_stencil", declines)
    # the process-wide stencil's derivative stencils, built afresh
    monkeypatch.setattr(K8_CASES["vadv_update"][0](np.float64, backend="cuda").backend,
                        "_derivatives", {})
    if reason in derivative.PLAIN_RERUN:
        _, counts, *got = _k8("vadv_update", None, monkeypatch)
        # the forward on the kernels, the gradient and both tangents re-run
        assert counts == (3, 3, 0, 0, 0, 3)
        assert float(got[0][0].abs().max()) > 0
    else:
        with pytest.raises(derivative.Declined, match=reason.split(" (")[0]):
            _k8("vadv_update", None, monkeypatch)


def test_no_derivative_rule_is_missing():
    """Every native function but ``gamma`` has a derivative rule; ``gamma``
    declines."""
    rules = derivative._Rules(ir.Stencil(
        name="s", api_params=[], field_decls={"a": ir.FieldDecl("a", np.dtype(np.float64))},
        scalar_decls={}, temp_decls={}, vertical_loops=[]))
    a = ir.FieldAccess("a")
    for fn in ir.NativeFunction:
        call = ir.NativeFuncCall(fn, [a] * fn.arity)
        if fn == ir.NativeFunction.GAMMA:
            with pytest.raises(derivative.Declined, match="gamma"):
                rules.rules(call)
        else:
            rules.rules(call)


def clash(a: gtscript.Field[np.float64], out: gtscript.Field[np.float64],
          out__c: gtscript.Field[np.float64], a__g: gtscript.Field[np.float64],
          a__d: gtscript.Field[np.float64], *, s: float):
    """Fields and temporaries named as the derivative names its own."""
    with computation(PARALLEL), interval(...):
        t__v1 = a[1, 0, 0] * a + s * a__d
        _dm1 = t__v1 * out__c
        if a > 0.5:
            out = _dm1 + a__g
        else:
            out = t__v1 - a__g * a
    with computation(FORWARD), interval(1, None):
        a__g = a__g[0, 0, -1] * 0.5 + out * a__d[-1, 0, 0]


@pytest.mark.parametrize("mode", ["torch", "emulated"])
def test_derivative_names_never_clash(request, mode):
    """A stencil whose own names are the derivative's (``a__g``, ``out__c``,
    ``a__d``, ``t__v1``, ``_dm1``): its adjoint and tangent stencils take
    other names, and their gradient and tangent equal the plain re-run's."""
    if mode == "emulated":
        request.getfixturevalue("emulated")
    rng = np.random.default_rng(31)
    shape = (9, 8, 5)
    fields = {k: rng.random(shape) for k in ("a", "out", "out__c", "a__g", "a__d")}
    weights = {k: rng.random(shape) for k in ("out", "a__g")}
    tans = [rng.random(shape) for _ in fields]
    got = {}
    for opt in ("kernels", None):
        st = gtscript.stencil(backend="cuda", definition=clash, rebuild=True, derivative=opt)
        fn = st.functional(origin=(1, 0, 0), domain=(7, 8, 5))

        def loss(*xs):
            outs = fn(**dict(zip(fields, xs)), s=1.7)
            return sum((outs[k] * torch.from_numpy(w)).sum() for k, w in weights.items())

        leaves = [torch.from_numpy(v).requires_grad_() for v in fields.values()]
        grads = torch.autograd.grad(loss(*leaves), leaves)
        _, tang = torch.func.jvp(loss, tuple(torch.from_numpy(v) for v in fields.values()),
                                 tuple(torch.from_numpy(t) for t in tans))
        got[opt] = (grads, tang)
        if opt == "kernels":
            assert (st.backend.adjoint_calls, st.backend.tangent_calls) == (1, 1)
            (d, _), = [v for k, v in st.backend._derivatives.items() if k[0] == "adjoint"]
            assert not set(d.grads.values()) & set(fields)
            assert not set(d.cots.values()) & set(fields)
    for a, r in zip(got["kernels"][0], got[None][0]):
        torch.testing.assert_close(a, r, **TOL)
        assert float(a.abs().max()) > 0
    torch.testing.assert_close(got["kernels"][1], got[None][1], **TOL)


# --------------------------------------------------------------------------- #
# second order
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _jax_hvp(name, wrt_name):
    """``jax.hessian`` of the entry's weighted outputs' sum with respect to
    ``wrt_name``, times a seeded direction: the direction and the product."""
    _, fields, scalars, origin, domain, _, weights, _, _ = _entry_setup(name)
    entry = stencil_defs.REGISTRY[name]
    fn = j_gtscript.stencil(backend="jax", definition=entry["definition"],
                            externals=entry["externals"], rebuild=True).functional(
        origin=origin, domain=domain)

    def loss(x):
        outs = fn(**{**{k: jnp.asarray(v) for k, v in fields.items()}, **scalars, wrt_name: x})
        return sum(jnp.sum(outs[k] * w) for k, w in weights.items())

    v = np.random.default_rng(41).random(fields[wrt_name].shape)
    h = np.asarray(jax.jit(jax.hessian(loss))(jnp.asarray(fields[wrt_name])))
    return v, np.tensordot(h, v, axes=v.ndim)


@pytest.mark.parametrize("mode", ["torch", "emulated"])
def test_second_order_vs_jax_hessian(request, mode):
    """The Hessian-vector product of the tridiagonal solve with respect to
    its diagonal three ways -- ``torch.func.jvp`` of ``torch.func.grad``,
    ``torch.func.grad`` of ``torch.func.grad``, and ``torch.autograd.grad``
    with ``create_graph=True`` -- through the derivative stencils' own
    tangent and adjoint stencils (``__adj__tan``, ``__adj__adj``), against
    ``jax.hessian``."""
    if mode == "emulated":
        request.getfixturevalue("emulated")
    name, wrt_name = "tridiagonal_solver", "diag"
    v, ref = _jax_hvp(name, wrt_name)
    entry, fields, scalars, origin, domain, _, weights, _, _ = _entry_setup(name)
    st = gtscript.stencil(backend="cuda", definition=entry["definition"],
                          externals=entry["externals"], rebuild=True, derivative="kernels")
    fn = st.functional(origin=origin, domain=domain)
    base = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in fields.items()}
    tv = torch.from_numpy(v)

    def loss(x):
        outs = fn(**{**base, **scalars, wrt_name: x})
        return sum((outs[k] * torch.from_numpy(w)).sum() for k, w in weights.items())

    x = base[wrt_name]
    hvps = [torch.func.jvp(torch.func.grad(loss), (x,), (tv,))[1],
            torch.func.grad(lambda x: (torch.func.grad(loss)(x) * tv).sum())(x)]
    leaf = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(leaf), leaf, create_graph=True)
    hvps.append(torch.autograd.grad((g * tv).sum(), leaf)[0])
    for h in hvps:
        np.testing.assert_allclose(h.detach().numpy(), ref, **TOL)
    assert float(np.abs(ref).max()) > 0
    (adj,) = st.backend.derivative_backends()["adjoint"]
    second = adj.derivative_backends()
    assert [b.analysis.stencil.name for b in second["tangent"]] == ["definition__adj__tan"]
    assert [b.analysis.stencil.name for b in second["adjoint"]] == ["definition__adj__adj"]
    assert (adj.tangent_calls, adj.adjoint_calls, adj.plain_reruns) == (1, 2, 0)
    if mode == "emulated":
        assert [b.launches for b in (*second["tangent"], *second["adjoint"])] == [1, 2]


# --------------------------------------------------------------------------- #
# the slice's stencils
# --------------------------------------------------------------------------- #

H = 3
DOMAIN = (8, 10, 4)
SHAPE = (DOMAIN[2], DOMAIN[0] + 2 * H, DOMAIN[1] + 2 * H)
ORIGIN = (H, H, 0)
#: stencil -> (port factory, JAX factory, the call (argument -> buffer),
#: scalars); the in-place hdiff reads and writes one buffer, as the models
#: call it
SLICE = {
    "hdiff": (dycore.make_hdiff, j_dycore.make_hdiff,
              dict(in_field="u", out_field="o", coeff="coeff"), {}),
    "hdiff_in_place": (dycore.make_hdiff, j_dycore.make_hdiff,
                       dict(in_field="u", out_field="u", coeff="coeff"), {}),
    "vadv_update": (dycore.make_vadv_update, j_dycore.make_vadv_update,
                    dict(utens_stage="utens_stage", u_stage="x", wcon="wcon", u_pos="y",
                         utens="utens", u_out="o"), {"dtr_stage": 3.0}),
    "fv_step": (fv_advection.make_fv_step, j_fv.make_fv_step,
                dict(q="u", cx="cx", cy="cy", qout="o"), {}),
}
LAYOUTS = {"tight": (), "periodic": ("I", "J")}


def _slice_inputs(name):
    """The case's buffers (physical (K, I, J)), the differentiated ones,
    the outputs' weights and the tangents, from fixed seeds."""
    _, _, call, _ = SLICE[name]
    rng = np.random.default_rng(23)
    scale = {"coeff": 0.025, "wcon": 0.2, "utens": 0.01}
    bufs = {b: scale.get(b, 1.0) * rng.random(SHAPE) for b in sorted(set(call.values()))}
    for b in ("cx", "cy"):
        if b in bufs:
            bufs[b] = 0.4 * (bufs[b] - 0.5)
    wrt = sorted(bufs)
    outs = {"hdiff": ["out_field"], "hdiff_in_place": ["out_field"],
            "vadv_update": ["utens_stage", "u_out"], "fv_step": ["qout"]}[name]
    weights = {o: rng.random(SHAPE) for o in outs}
    tans = [rng.random(SHAPE) for _ in wrt]
    return bufs, wrt, weights, tans


@functools.lru_cache(maxsize=None)
def _slice_jax(name, layout):
    _, jfactory, call, scalars = SLICE[name]
    bufs, wrt, weights, tans = _slice_inputs(name)
    fn = jfactory(np.float64, backend="jax").functional(
        origin=ORIGIN, domain=DOMAIN, physical_layout=True, periodic=LAYOUTS[layout])

    def loss(*xs):
        b = {**bufs, **dict(zip(wrt, xs))}
        outs = fn(**{a: jnp.asarray(b[k]) for a, k in call.items()}, **scalars)
        return sum(jnp.sum(outs[o] * w) for o, w in weights.items())

    xs = [jnp.asarray(bufs[k]) for k in wrt]
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*xs)
    _, tang = jax.jit(lambda a, t: jax.jvp(loss, a, t))(
        tuple(xs), tuple(jnp.asarray(t) for t in tans))
    return [np.asarray(g) for g in grads], float(tang)


@functools.lru_cache(maxsize=None)
def _slice_plain(name, layout):
    """``_slice_port`` with the derivative stencils on the plain executor
    (no emulation), shared by the tests that read it."""
    return _slice_port(name, layout)


def _slice_port(name, layout):
    """The port's gradients, tangent and the outputs' tangents (for the
    dot-product identity), with ``derivative="kernels"``."""
    factory, _, call, scalars = SLICE[name]
    bufs, wrt, weights, tans = _slice_inputs(name)
    st = factory(np.float64, backend="cuda", derivative="kernels", rebuild=True)
    fn = st.functional(origin=ORIGIN, domain=DOMAIN, physical_layout=True,
                       periodic=LAYOUTS[layout])

    def outputs(*xs):
        b = {**{k: torch.from_numpy(v) for k, v in bufs.items()}, **dict(zip(wrt, xs))}
        return fn(**{a: b[k] for a, k in call.items()}, **scalars)

    def loss(*xs):
        outs = outputs(*xs)
        return sum((outs[o] * torch.from_numpy(w)).sum() for o, w in weights.items())

    xs = [torch.from_numpy(bufs[k]) for k in wrt]
    leaves = [x.clone().requires_grad_() for x in xs]
    grads = [g.numpy() for g in torch.autograd.grad(loss(*leaves), leaves)]
    _, tang = torch.func.jvp(loss, tuple(xs), tuple(torch.from_numpy(t) for t in tans))
    _, out_tans = torch.func.jvp(outputs, tuple(xs), tuple(torch.from_numpy(t) for t in tans))
    return st, grads, float(tang), out_tans, weights, tans


@pytest.mark.parametrize("mode", ["torch", "emulated"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_stencils_vs_jax(request, name, layout, mode):
    """hdiff (and its in-place call), vadv_update and fv_step: gradient and
    tangent from the derivative stencils, on the plain executor and on the
    emulated kernels, against the JAX package's, on the tight layout with
    halos (the gradients at halo points the forward read) and the periodic
    one; the adjoint's kernel forms are the slice's (K1 tile form, K2 fused
    column kernel)."""
    if mode == "emulated":
        request.getfixturevalue("emulated")
    ref_grads, ref_tang = _slice_jax(name, layout)
    st, grads, tang, _, _, _ = _slice_port(name, layout) if mode == "emulated" else \
        _slice_plain(name, layout)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)
    np.testing.assert_allclose(tang, ref_tang, **TOL)
    assert (st.backend.adjoint_calls, st.backend.tangent_calls) == (1, 2)
    forms = cuda_backend.LAST_PLAN[st.backend.analysis.stencil.name]["adjoint"]["forms"]
    assert forms == (["column", "rows"] if name == "vadv_update" else ["tile"]), forms
    if mode == "emulated":
        for kind, backends in st.backend.derivative_backends().items():
            assert [b.launches for b in backends] == [1 if kind == "adjoint" else 2], kind


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(SLICE))
def test_dot_product_identity(name, layout):
    """<J v, w> from the tangent stencil equals <v, J^T w> from the adjoint
    stencil."""
    _, grads, _, out_tans, weights, tans = _slice_plain(name, layout)
    jv_w = sum(float((out_tans[o] * torch.from_numpy(w)).sum()) for o, w in weights.items())
    v_jtw = sum(float(np.vdot(t, g)) for t, g in zip(tans, grads))
    np.testing.assert_allclose(jv_w, v_jtw, rtol=1e-12, atol=0)


# --------------------------------------------------------------------------- #
# model steps and K8's cases on the emulated kernels
# --------------------------------------------------------------------------- #


def test_minidycore_step_grad_emulated(emulated, jax_dycore_grad):  # noqa: F811
    """The MiniDycore(8, 8, 4) step gradient with the backward on the
    emulated adjoint kernels of hdiff and vadv_update."""
    state, g_jax = jax_dycore_grad
    pm = dycore.MiniDycore(8, 8, 4, dtype=np.float64, backend="cuda", aligned=False,
                           device="cpu", options={"derivative": "kernels"})
    pstate = state_from_numpy(state, "cpu")
    leaf = pstate["u"].clone().requires_grad_()
    before = [st.backend.adjoint_calls for st in (pm.hdiff, pm.vadv_upd)]
    (g,) = torch.autograd.grad((pm.step_fn()({**pstate, "u": leaf})["u"] ** 2).sum(), leaf)
    assert [st.backend.adjoint_calls - b for st, b in zip((pm.hdiff, pm.vadv_upd), before)] == \
        [1, 1]
    np.testing.assert_allclose(g.numpy(), g_jax, **TOL)


def test_full_dycore_step_grad_emulated(emulated, monkeypatch, jax_full_grad):  # noqa: F811
    """The FullDycore(16, 16, 4) step gradient with respect to u and q, the
    backward on the emulated adjoint kernels of hdiff, vadv_update and
    fv_step (sl_step reads neither)."""
    state, g_jax = jax_full_grad
    pm = full_dycore.FullDycore(16, 16, 4, dtype=np.float64, backend="cuda", aligned=False,
                                device="cpu")
    pstate = state_from_numpy(state, "cpu")
    u, q = (pstate[k].clone().requires_grad_() for k in ("u", "q"))
    path = (pm.dyn.hdiff, pm.dyn.vadv_upd, pm.fv.fv_step)
    for st in path:
        monkeypatch.setattr(st.backend, "derivative_opt", "kernels")

    def counts():
        return [(st.backend.adjoint_calls,
                 sum(b.launches for b in st.backend.derivative_backends()["adjoint"]))
                for st in path]

    before = counts()
    out = pm.step_fn()({**pstate, "u": u, "q": q})
    got = torch.autograd.grad(sum((out[k] ** 2).sum() for k in FULL_PROGNOSTIC), (u, q))
    assert [(a - c, b - d) for (a, b), (c, d) in zip(counts(), before)] == [(1, 1)] * 3
    for name, g, ref in zip(("u", "q"), got, g_jax):
        np.testing.assert_allclose(g.numpy(), ref, **TOL, err_msg=name)


def _counts(st):
    """A stencil's launches, K8 engagements, adjoint and tangent calls, the
    adjoint kernels' launches and the plain re-runs."""
    b = st.backend
    return (b.launches, b.derivative_calls, b.adjoint_calls, b.tangent_calls,
            sum(d.launches for d in b.derivative_backends()["adjoint"]), b.plain_reruns)


def _k8(name, opt, monkeypatch):
    """The card tests' K8 case ``name`` with ``derivative=opt`` (set on the
    process-wide stencil for the test only): the stencil, the counts of the
    calls (``_counts``), then the gradient, ``torch.func.jvp`` (value,
    tangent) and the forward-mode tangent of the loss."""
    factory, call, scalars, wrt = K8_CASES[name]
    st = factory(np.float64, backend="cuda")
    monkeypatch.setattr(st.backend, "derivative_opt", opt)
    start = _counts(st)
    physical = name != "weighted_scan"
    fn = st.functional(origin=(3, 3, 0), domain=DOMAIN, physical_layout=physical,
                       periodic=("I", "J") if physical else ())
    bufs = _buffers(np.float64, "cpu", seed=7)
    if not physical:
        bufs = {k: v.permute(1, 2, 0) for k, v in bufs.items()}
    prims = [torch.tensor(1.3, dtype=torch.float64) if n == "w" else bufs[n] for n in wrt]
    rng = np.random.default_rng(9)
    tans = [torch.ones_like(p) if p.ndim == 0 else torch.from_numpy(rng.random(tuple(p.shape)))
            for p in prims]

    def f(*xs):
        b = dict(bufs)
        b.update({n: x for n, x in zip(wrt, xs) if n != "w"})
        sc = dict(scalars, **({"w": xs[wrt.index("w")]} if "w" in wrt else {}))
        outs = fn(**{a: b[k] for a, k in call.items()}, **sc)
        return sum((o ** 2).sum() for o in outs.values())

    leaves = [p.clone().requires_grad_() for p in prims]
    grads = torch.autograd.grad(f(*leaves), leaves)
    value, tang = torch.func.jvp(f, tuple(prims), tuple(tans))
    with fwAD.dual_level():
        tang_fw = fwAD.unpack_dual(f(*[fwAD.make_dual(p, t) for p, t in zip(prims, tans)])).tangent
    counts = tuple(a - b for a, b in zip(_counts(st), start))
    return st, counts, grads, value, tang, tang_fw


@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_cases_emulated(emulated, monkeypatch, name):  # noqa: F811
    """The card tests' K8 cases (hdiff in place, vadv_update, a scan with a
    tensor scalar): the forward, the adjoint and the tangent all on the
    emulated kernels, against the plain re-run at rtol 1e-12 (the gathers
    sum in another order, so not bit for bit)."""
    _, counts, *got = _k8(name, "kernels", monkeypatch)
    _, _, *ref = _k8(name, None, monkeypatch)  # CPU tensors: the plain re-run
    # three forward launches under K8, one adjoint call of one launch, two
    # tangent calls (torch.func.jvp and forward mode), no plain re-run
    assert counts == (3, 3, 1, 2, 1, 0)
    for a, b in zip(got[0], ref[0]):
        torch.testing.assert_close(a, b, **TOL)
        assert float(a.abs().max()) > 0
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, **TOL)


def test_derivative_launch_failure_raises(emulated, monkeypatch):  # noqa: F811
    """A derivative kernel that fails to launch raises: nothing computes the
    gradient with the plain re-run instead."""
    real = cuda_backend.CudaBackend._launch

    def launch(self, *args, **kw):
        if self.analysis.stencil.name.endswith("__adj"):
            raise RuntimeError(f"CUDA launch failed in stencil '{self.analysis.stencil.name}'")
        return real(self, *args, **kw)

    monkeypatch.setattr(cuda_backend.CudaBackend, "_launch", launch)
    with pytest.raises(RuntimeError, match="launch failed in stencil 'hdiff_float64__adj'"):
        _k8("hdiff", "kernels", monkeypatch)


def test_default_keeps_the_plain_rerun_on_the_cpu(emulated, monkeypatch):  # noqa: F811
    """By default the derivative stencils run for CUDA tensors only: on CPU
    tensors the backward and both tangents are the plain re-run, and the
    gradient is the ``"torch"`` backend's bit for bit."""
    _, counts, *got = _k8("vadv_update", None, monkeypatch)
    assert counts == (3, 3, 0, 0, 0, 3)
    factory, call, scalars, wrt = K8_CASES["vadv_update"]
    fn = factory(np.float64, backend="torch").functional(
        origin=(3, 3, 0), domain=DOMAIN, physical_layout=True, periodic=("I", "J"))
    bufs = _buffers(np.float64, "cpu", seed=7)
    leaves = [bufs[n].clone().requires_grad_() for n in wrt]
    b = {**bufs, **dict(zip(wrt, leaves))}
    loss = sum((o ** 2).sum() for o in fn(**{a: b[k] for a, k in call.items()},
                                           **scalars).values())
    for a, r in zip(got[0], torch.autograd.grad(loss, leaves)):
        assert torch.equal(a, r)


#: K10's lowered calls: (source, argument spec) of an operator and a scan,
#: and a program run as one fused segment
NEXT_CASES = {"operator": test_torch_next.OPERATORS["hdiff"],
              "scan": test_torch_next.SCANS["decay_backward"],
              "program": (test_torch_next.PROGRAMS["hdiff_prog"], None)}


def _next_grad(kind, backend):
    """The gradient of the sum of squares of a next call's output with
    respect to its first field, on ``backend``, and the call."""
    src, spec = NEXT_CASES[kind]
    _, pns = test_torch_next.both(src)
    if spec is None:
        args = test_torch_next.program_args(pns, pgtx, "torch")
    else:
        args = test_torch_next.make_args(spec, pns, pgtx, 4, "torch")
    leaf = args[0].data.clone().requires_grad_()
    args[0] = pgtx.Field(args[0].domain, leaf)
    if spec is None:
        obj = pns["prog"].with_backend(backend)
        old = config.PROGRAM_FUSION
        config.PROGRAM_FUSION = True
        try:
            obj(*args)
        finally:
            config.PROGRAM_FUSION = old
        out = args[-1].data
    else:
        obj = pns["op"].with_backend(backend)
        out = obj(*args).data
    (g,) = torch.autograd.grad((out ** 2).sum(), leaf)
    return g, obj


@pytest.mark.parametrize("kind", list(NEXT_CASES))
def test_next_bridge_on_the_derivative_kernels(emulated, monkeypatch, kind):  # noqa: F811
    """K10's operators, scans and fused program segments on the emulated
    kernels with the card's rule: each lowered call hands its outputs back
    through ``apply``'s ``outputs``, its backward runs the lowered
    stencil's adjoint kernels, and the gradient equals the embedded
    executor's."""
    monkeypatch.setattr(autodiff, "_on_kernels", lambda call, tensors: call.kernels is not None)
    ref, _ = _next_grad(kind, "torch")
    got, obj = _next_grad(kind, "cuda")
    kernels = cuda_bridge.kernels_of(obj)
    assert kernels
    assert sum(k.adjoint_calls for k in kernels) >= 1
    assert sum(k.plain_reruns for k in kernels) == 0
    assert sum(d.launches for k in kernels for d in k.derivative_backends()["adjoint"]) >= 1
    torch.testing.assert_close(got, ref, **TOL)
    assert float(ref.abs().max()) > 0


# --------------------------------------------------------------------------- #
# random programs
# --------------------------------------------------------------------------- #

#: fuzzer seeds (without ``while``) whose adjoints run: serial loops with
#: reads across section bounds and in K halos, ifs and regions read at
#: offsets beyond their extent, variable- and absolute-K reads in partials
FUZZ = [(5, ()), (16, ()), (24, ()), (71, ()), (71, ("I", "J")), (9, ("I", "J"))]
FUZZ_EMULATED = [(16, ()), (71, ("I", "J"))]


def _fuzz_grads(seed, periodic, derivative_opt):
    """The gradient of a weighted sum of a random program's outputs with
    respect to its float inputs (those read at a variable or absolute K
    excepted) and scalars, on ``"cuda"`` with ``derivative_opt`` or (None)
    the ``"torch"`` executor; the inputs' K halo grown to 3."""
    case = program_gen.DifferentialCase(seed, periodic=periodic, allow_while=False)
    an = case.analysis
    backend = TorchBackend(an, {}) if derivative_opt is None else \
        cuda_backend.CudaBackend(an, {"derivative": derivative_opt})
    st = StencilObject(analysis=an, backend=backend, backend_name="cuda", name=an.stencil.name,
                       options={}, stencil_id=f"derivative-fuzz-{seed}-{derivative_opt}")
    fn = st.functional(origin=(case.origin[0], case.origin[1], 3), domain=case.domain,
                       periodic=periodic)
    at_k = {a.name for a in ir.field_accesses(an.stencil.vertical_loops)
            if not isinstance(a.offset, ir.CartesianOffset)}
    rng = np.random.default_rng(seed + 7)
    fields = {}
    for n, a in case.inputs.items():
        a = np.asarray(a)
        fields[n] = torch.from_numpy(np.concatenate(
            [rng.random(a.shape[:2] + (2,)), a, rng.random(a.shape[:2] + (2,))], axis=2))
    leaves = {n: t.requires_grad_() for n, t in fields.items() if n not in at_k}
    scalars = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for k, v in case.scalars.items()}
    outs = fn(**fields, **scalars)
    loss = sum((o * torch.from_numpy(rng.random(tuple(o.shape)))).sum() for o in outs.values())
    wrt = [*leaves.values(), *scalars.values()]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)], backend


def _check_fuzz(seed, periodic):
    got, backend = _fuzz_grads(seed, periodic, "kernels")
    ref, _ = _fuzz_grads(seed, periodic, None)
    assert backend.adjoint_calls == 1 and backend.plain_reruns == 0
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12 * scale)
    return backend


@pytest.mark.parametrize("seed, periodic", FUZZ)
def test_fuzz_programs_vs_plain(seed, periodic):
    """The adjoint stencil of random programs on the plain executor
    against autograd through the plain executor."""
    _check_fuzz(seed, periodic)


@pytest.mark.parametrize("seed, periodic", FUZZ_EMULATED)
def test_fuzz_programs_emulated_vs_plain(emulated, seed, periodic):  # noqa: F811
    """The same with the forward and the adjoint on the emulated kernels."""
    backend = _check_fuzz(seed, periodic)
    assert [b.launches for b in backend.derivative_backends()["adjoint"]] == [1]
