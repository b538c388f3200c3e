"""Gradients through the port, held to the JAX package's.

Every test of ``tests/cartesian/test_autodiff.py`` and
``tests/next/test_autodiff.py`` has a counterpart here: the same seeded
numpy inputs go through the JAX function (``backend="jax"`` or
``"pallas"``, as the JAX test runs it; pallas interprets on the CPU) and
through the port, and the gradients (and tangents) agree at rtol 1e-12 in
float64.  Beyond those:

- the MiniDycore and ``FullDycore(16, 16, 4)`` step gradients, the state
  carried over with ``state_from_numpy``;
- the sort-routed FVM energy on ``shuffled_mesh(200, 7)`` in float32 (K9
  moves 32-bit words only), against the JAX gradient and the index path at
  rtol 1e-5, with its plans engaged and no permutation declined;
- K8's plumbing (``cartesian/backend/autodiff.py``) without a card: the
  generated kernels built by the host compiler (``tests/test_torch_emulated.py``)
  run as the forward of hdiff, vadv_update, a scan with a tensor scalar and
  a next operator, and their gradient, ``torch.func.jvp`` and forward-mode
  tangent equal the plain executor's bit for bit; K8 engages only when a
  derivative is wanted, and never changes the launch count.

What they guard: a serial stencil's read at a K offset must not save a
view that the next level's in-place write modifies (``product_scan``,
``carried_product``, the dycore steps); a routed gather must stay in the
graph although K9 moves raw 32-bit words; the kernels' outputs must carry
the gradient of what they read, under ``torch.func`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import gt4py_tpu.next as jgtx
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval
from gt4py_tpu.models import dycore as j_dycore
from gt4py_tpu.models import full_dycore as j_full
from gt4py_tpu.next import testing as jt

import gt4py_tpu_torch.next as pgtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript as pgtscript
from gt4py_tpu_torch.cartesian.backend import cuda_backend
from gt4py_tpu_torch.models import dycore as p_dycore
from gt4py_tpu_torch.models import full_dycore as p_full
from gt4py_tpu_torch.models.dycore import state_from_numpy
from gt4py_tpu_torch.next import affine_remap, benes, cuda_bridge, sort_route
from gt4py_tpu_torch.next import testing as pt

from .test_torch_cuda import K8_CASES, _buffers, k8_call, k8_counts, k8_derivatives
from .test_torch_emulated import emulated, emulated_dir  # noqa: F401  (fixtures)
from .test_torch_frontend import to_port
from .test_torch_next import both, define


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


TOL = dict(rtol=1e-12, atol=0)
Field3D = gtscript.Field[np.float64]
BACKENDS = ["torch", "cuda"]


def _grad(loss, *xs):
    """``torch.autograd.grad`` of ``loss(*leaves)`` at fresh leaves made
    from the numpy arrays ``xs``."""
    leaves = [torch.from_numpy(np.array(x)).requires_grad_() for x in xs]
    return [g.numpy() for g in torch.autograd.grad(loss(*leaves), leaves)]


# --------------------------------------------------------------------------- #
# the cartesian DSL (tests/cartesian/test_autodiff.py)
# --------------------------------------------------------------------------- #


def smooth(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = 0.25 * (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])


def cumsum(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp


def shifted_product(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = inp[1, 0, 0] * inp


def relax(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        out = inp - 0.1 * (lap - 4.0 * inp)


def weighted_scan(inp: Field3D, out: Field3D, *, w: np.float64):
    with computation(FORWARD):
        with interval(0, 1):
            out = w * inp
        with interval(1, None):
            out = out[0, 0, -1] + w * inp


def product_scan(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] * inp * 0.5 + inp


def damped_back(inp: Field3D, out: Field3D):
    with computation(BACKWARD):
        with interval(-1, None):
            out = inp * inp
        with interval(0, -1):
            out = 0.5 * out[0, 0, 1] + inp * inp


def _functionals(defn, jbackend, pbackend, origin, domain):
    jst = gtscript.stencil(backend=jbackend, name=f"{defn.__name__}_{jbackend}")(defn)
    pst = pgtscript.stencil(backend=pbackend, definition=to_port(defn), rebuild=True)
    return (jst.functional(origin=origin, domain=domain),
            pst.functional(origin=origin, domain=domain), pst)


def _sum_sq_loss(fn, zeros, **scalars):
    return lambda x, **kw: (fn(inp=x, out=zeros(x), **scalars, **kw)["out"] ** 2).sum()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("defn, origin, domain, shape, seed", [
    (smooth, (1, 1, 0), (4, 4, 2), (6, 6, 2), 0),
    (cumsum, (0, 0, 0), (2, 2, 5), (2, 2, 5), 1),
    (relax, (1, 1, 0), (6, 6, 3), (8, 8, 3), 3),
    (damped_back, (0, 0, 0), (3, 4, 6), (3, 4, 6), 5),
    (product_scan, (0, 0, 0), (3, 4, 6), (3, 4, 6), 6),
], ids=["parallel_stencil", "tridiagonal_scan", "relax", "backward_scan", "product_scan"])
def test_stencil_grad_vs_jax(backend, defn, origin, domain, shape, seed):
    """jax.grad of ``sum(out**2)`` on the ``"jax"`` backend against
    torch.autograd.grad on the port (the JAX tests' first two stencils, the
    relaxation of ``test_grad_through_pallas_backend``, a BACKWARD
    recurrence and a recurrence whose carry multiplies the input: the
    product saves the carry, a view of the field the scan writes)."""
    jfn, pfn, _ = _functionals(defn, "jax", backend, origin, domain)
    x = np.random.default_rng(seed).random(shape)
    g_jax = np.asarray(jax.grad(_sum_sq_loss(jfn, jnp.zeros_like))(jnp.asarray(x)))
    (g,) = _grad(_sum_sq_loss(pfn, torch.zeros_like), x)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_jax, **TOL)


@pytest.fixture(scope="module")
def jax_dycore_grad():
    """The JAX MiniDycore(8, 8, 4) float64 (tight layout): its state and the
    gradient of ``sum(u**2)`` after one step with respect to the initial
    ``u``."""
    jm = j_dycore.MiniDycore(8, 8, 4, dtype=np.float64, backend="jax", aligned=False)
    state = jm.init_state()
    jstep = jm.step_fn()

    def jloss(u):
        s = {k: jnp.asarray(v) for k, v in state.items()}
        s["u"] = u
        return jnp.sum(jstep(s)["u"] ** 2)

    return state, np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(state["u"])))


@pytest.mark.parametrize("backend", BACKENDS)
def test_grad_through_dycore_step(backend, jax_dycore_grad):
    """The gradient of ``sum(u**2)`` after one MiniDycore step with respect
    to the initial ``u``: equal to the JAX model's, finite and nonzero, and
    its directional derivative matches central differences (rtol 1e-4, as
    the JAX test)."""
    state, g_jax = jax_dycore_grad
    pm = p_dycore.MiniDycore(8, 8, 4, dtype=np.float64, backend=backend, aligned=False,
                             device="cpu")
    pstate = state_from_numpy(state, "cpu")
    pstep = pm.step_fn()

    def loss(u):
        return (pstep({**pstate, "u": u})["u"] ** 2).sum()

    (g,) = _grad(loss, state["u"])
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_jax, **TOL)
    v = np.random.default_rng(2).random(g.shape)
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(torch.from_numpy(state["u"] + eps * v))
              - loss(torch.from_numpy(state["u"] - eps * v))) / (2 * eps)
    np.testing.assert_allclose(float(np.vdot(g, v)), float(fd), rtol=1e-4)


FULL_PROGNOSTIC = ("u", "q", "qsl")


@pytest.fixture(scope="module")
def jax_full_grad():
    """The JAX FullDycore(16, 16, 4) float64 (tight layout): its state and
    the gradient of the sum of squares of the step's prognostic outputs
    (u, q, qsl) with respect to the initial u and q."""
    jm = j_full.FullDycore(16, 16, 4, dtype=np.float64, backend="jax", aligned=False)
    state = jm.init_state(seed=0)
    jstep = jm.step_fn()

    def jloss(u, q):
        s = {k: jnp.asarray(v) for k, v in state.items()}
        out = jstep({**s, "u": u, "q": q})
        return sum(jnp.sum(out[k] ** 2) for k in FULL_PROGNOSTIC)

    grads = jax.jit(jax.grad(jloss, (0, 1)))(jnp.asarray(state["u"]), jnp.asarray(state["q"]))
    return state, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("backend", BACKENDS)
def test_grad_through_full_dycore_step(backend, jax_full_grad):
    state, g_jax = jax_full_grad
    pm = p_full.FullDycore(16, 16, 4, dtype=np.float64, backend=backend, aligned=False,
                           device="cpu")
    pstate = state_from_numpy(state, "cpu")
    pstep = pm.step_fn()

    def loss(u, q):
        out = pstep({**pstate, "u": u, "q": q})
        return sum((out[k] ** 2).sum() for k in FULL_PROGNOSTIC)

    got = _grad(loss, state["u"], state["q"])
    for name, g, ref in zip(("u", "q"), got, g_jax):
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, ref, **TOL, err_msg=name)


def test_jvp_through_cuda_backend():
    """torch.func.jvp and forward-mode AD through ``"cuda"`` equal
    jax.jvp through ``"pallas"`` (the JAX test's stencil ``inp[1] * inp``)."""
    jfn, pfn, _ = _functionals(shifted_product, "pallas", "cuda", (0, 0, 0), (4, 5, 2))
    rng = np.random.default_rng(11)
    x, t = rng.random((5, 5, 2)), rng.random((5, 5, 2))
    jp, jt_ = jax.jvp(lambda a: jfn(inp=a, out=jnp.zeros_like(a))["out"],
                      (jnp.asarray(x),), (jnp.asarray(t),))

    def f(a):
        return pfn(inp=a, out=torch.zeros_like(a))["out"]

    p, tang = torch.func.jvp(f, (torch.from_numpy(x),), (torch.from_numpy(t),))
    with fwAD.dual_level():
        tang_fw = fwAD.unpack_dual(f(fwAD.make_dual(torch.from_numpy(x),
                                                    torch.from_numpy(t)))).tangent
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tang.numpy(), np.asarray(jt_), **TOL)
    np.testing.assert_array_equal(tang_fw.numpy(), tang.numpy())
    assert np.abs(tang.numpy()).max() > 0


def test_grad_through_cuda_backend():
    """The relaxation stencil's gradient through ``"cuda"`` equals the JAX
    package's through ``"pallas"``."""
    jfn, pfn, _ = _functionals(relax, "pallas", "cuda", (1, 1, 0), (6, 6, 3))
    x = np.random.default_rng(3).random((8, 8, 3))
    g_pal = np.asarray(jax.grad(_sum_sq_loss(jfn, jnp.zeros_like))(jnp.asarray(x)))
    (g,) = _grad(_sum_sq_loss(pfn, torch.zeros_like), x)
    np.testing.assert_allclose(g, g_pal, **TOL)
    assert np.abs(g).max() > 0


@pytest.mark.parametrize("argnum", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_grad_through_scan_and_scalar(backend, argnum):
    """A FORWARD scan with a tensor scalar ``w``: the gradient with
    respect to the field and to ``w`` equals the JAX package's through
    ``"pallas"`` under jit."""
    jfn, pfn, _ = _functionals(weighted_scan, "pallas", backend, (0, 0, 0), (4, 4, 5))
    x = np.random.default_rng(4).random((4, 4, 5))
    w = np.asarray(1.3)

    def jloss(a, w):
        return jnp.sum(jfn(inp=a, out=jnp.zeros_like(a), w=w)["out"] ** 2)

    def loss(a, w):
        return (pfn(inp=a, out=torch.zeros_like(a), w=w)["out"] ** 2).sum()

    g_jax = np.asarray(jax.jit(jax.grad(jloss, argnum))(jnp.asarray(x), jnp.asarray(w)))
    g = _grad(loss, x, w)[argnum]
    np.testing.assert_allclose(g, g_jax, **TOL)


def test_in_place_call_refuses_a_leaf_output():
    """The in-place ``__call__`` writes into its arguments: a leaf that
    requires grad cannot be a written field (gradients go through
    ``functional``)."""
    st = pgtscript.stencil(backend="cuda", definition=to_port(smooth), rebuild=True)
    inp = torch.rand(6, 6, 2, dtype=torch.float64)
    out = torch.zeros(6, 6, 2, dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="functional"):
        st(inp, out, origin=(1, 1, 0), domain=(4, 4, 2))


# --------------------------------------------------------------------------- #
# the next DSL (tests/next/test_autodiff.py)
# --------------------------------------------------------------------------- #

NEXT_OPS = """
IK = Field[Dims[I, K], float64]

@field_operator
def energy_op(f: IK) -> IK:
    g = f(Ioff[1]) - f
    return g * g

@scan_operator(axis=K, forward=True, init=0.0)
def damped_sum(c: float, x: float) -> float:
    return c * 0.9 + x

@scan_operator(axis=K, forward=False, init=0.0)
def back(c: float, x: float) -> float:
    return 0.5 * c + x * x

@scan_operator(axis=K, forward=True, init=1.0)
def carried_product(c: float, x: float) -> float:
    return c * x * 0.5 + x

@field_operator
def scaled(f: IK, w: float64) -> IK:
    d = f(Ioff[1]) - f
    return where(d > 0.0, w * d, 0.5 * w * d)

@field_operator
def bridge_op(a: FT) -> FT:
    return (a(Ioff[1]) - a) * (a(Ioff[-1]) + 2.0)
"""
JOPS, POPS = both(NEXT_OPS)


def _pfield(dims, x):
    return pgtx.as_field(tuple(POPS[d] for d in dims), x)


def _jfield(dims, x):
    return jgtx.as_field(tuple(JOPS[d] for d in dims), x)


def _next_ops(backend, *names):
    return [POPS[n].with_backend(backend) for n in names]


@pytest.mark.parametrize("backend", BACKENDS)
def test_next_grad_through_operator_and_scan(backend):
    """``damped_sum(energy_op(f))``; on ``"cuda"`` both lower onto the
    cartesian kernels (the scan onto the column form)."""
    data = np.random.default_rng(0).random((6, 4))
    energy, scan = _next_ops(backend, "energy_op", "damped_sum")
    cursor = cuda_bridge.FALLBACK_EVENTS.cursor()

    def loss(x):
        return scan(energy(_pfield("IK", x))).data.sum()

    g_jax = np.asarray(jax.grad(
        lambda a: jnp.sum(JOPS["damped_sum"](JOPS["energy_op"](_jfield("IK", a))).data))(
        jnp.asarray(data)))
    g_jit = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(JOPS["damped_sum"](JOPS["energy_op"](_jfield("IK", a))).data)))(
        jnp.asarray(data)))
    (g,) = _grad(loss, data)
    (again,) = _grad(loss, data)
    np.testing.assert_allclose(g, g_jax, **TOL)
    np.testing.assert_allclose(g, g_jit, **TOL)
    np.testing.assert_array_equal(g, again)
    if backend == "cuda":
        assert not cuda_bridge.FALLBACK_EVENTS.since(cursor)
        assert cuda_bridge.kernels_of(scan)


@pytest.mark.parametrize("backend", BACKENDS)
def test_next_grad_wrt_scalar_parameter(backend):
    data = np.random.default_rng(1).random((5, 3)) - 0.5
    (op,) = _next_ops(backend, "scaled")

    def loss(w):
        return (op(_pfield("IK", torch.from_numpy(data)), w).data ** 2).sum()

    g_jax = float(jax.grad(lambda w: jnp.sum(
        JOPS["scaled"](_jfield("IK", data), w).data ** 2))(0.7))
    (g,) = _grad(loss, np.float64(0.7))
    np.testing.assert_allclose(float(g), g_jax, **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scan", ["back", "carried_product"])
def test_next_grad_scan(backend, scan):
    """A BACKWARD scan, and a FORWARD one whose carry multiplies the input
    (on ``"cuda"``: the column kernel's plain executor on the CPU)."""
    data = np.random.default_rng(3).random((4, 5))
    (op,) = _next_ops(backend, scan)
    g_jax = np.asarray(jax.grad(lambda a: jnp.sum(JOPS[scan](_jfield("IK", a)).data))(
        jnp.asarray(data)))
    (g,) = _grad(lambda x: op(_pfield("IK", x)).data.sum(), data)
    np.testing.assert_allclose(g, g_jax, **TOL)


def test_next_grad_through_bridge_kernel():
    """The bridge's kernels (``"cuda"``) against the JAX package's
    (``"pallas"``)."""
    data = np.random.default_rng(0).random((10, 6, 4))

    def dom(pkg, ns):
        return pkg.Domain((ns["I"], ns["J"], ns["K"]),
                          (pkg.UnitRange(0, 10), pkg.UnitRange(0, 6), pkg.UnitRange(0, 4)))

    jop = JOPS["bridge_op"].with_backend("pallas")
    g_jax = np.asarray(jax.grad(lambda x: jnp.sum(
        jop(jgtx.Field(dom(jgtx, JOPS), x)).data ** 2))(jnp.asarray(data)))
    op = POPS["bridge_op"].with_backend("cuda")
    (g,) = _grad(lambda x: (op(pgtx.Field(dom(pgtx, POPS), x)).data ** 2).sum(), data)
    assert cuda_bridge.kernels_of(op)
    np.testing.assert_allclose(g, g_jax, **TOL)


def _fvm_energy(mesh, pkg, sign, dtype):
    """The JAX test's FVM energy ``sum(divergence(gradient(psi))**2)``
    on one package's operators."""
    E, V = (jt.Edge, jt.Vertex) if pkg is jgtx else (pt.Edge, pt.Vertex)
    E2VDim, V2EDim = (jt.E2VDim, jt.V2EDim) if pkg is jgtx else (pt.E2VDim, pt.V2EDim)
    E2V = pkg.FieldOffset("E2V", source=V, target=(E, E2VDim))
    V2E = pkg.FieldOffset("V2E", source=E, target=(V, V2EDim))
    T = pkg.float32 if dtype == np.float32 else pkg.float64
    ns = dict(Field=pkg.Field, Dims=pkg.Dims, E=E, V=V, V2EDim=V2EDim, E2V=E2V, V2E=V2E,
              T=T, neighbor_sum=pkg.neighbor_sum, field_operator=pkg.field_operator)
    ops = define("""
        @field_operator
        def gradient(psi: Field[Dims[V], T]) -> Field[Dims[E], T]:
            return psi(E2V[1]) - psi(E2V[0])

        @field_operator
        def divergence(flux: Field[Dims[E], T], sign: Field[Dims[V, V2EDim], T]
                       ) -> Field[Dims[V], T]:
            return neighbor_sum(flux(V2E) * sign, axis=V2EDim)
        """, ns)
    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    sign_f = pkg.as_field((V, V2EDim), sign if pkg is pgtx else jnp.asarray(sign))

    def energy(p):
        d = ops["divergence"](ops["gradient"](pkg.as_field((V,), p), offset_provider=provider),
                              sign_f, offset_provider=provider)
        return (d.data ** 2).sum()

    return energy


def _sign(mesh, dtype):
    t = np.asarray(mesh.v2e.table)
    first = np.asarray(mesh.e2v.table)[np.clip(t, 0, mesh.n_edges - 1), 0]
    return np.where(t == -1, 0.0, np.where(first == np.arange(mesh.n_vertices)[:, None],
                                           1.0, -1.0)).astype(dtype)


def _fvm_grads(make_mesh, dtype, monkeypatch, plan_for):
    """The energy's gradient on the JAX package (plans on), on the port with
    its plans on (asserted engaged, no permutation declined), and on the
    port's index path (``config.AFFINE_GATHER = config.SORT_GATHER =
    False``, fresh connectivities)."""
    jmesh, pmesh = make_mesh(jt), make_mesh(pt)
    sign = _sign(pmesh, dtype)
    psi = np.random.default_rng(31).random(pmesh.n_vertices).astype(dtype)
    g_jax = np.asarray(jax.jit(jax.grad(_fvm_energy(jmesh, jgtx, sign, dtype)))(jnp.asarray(psi)))
    cursor = benes.DECLINES.cursor()
    (g,) = _grad(_fvm_energy(pmesh, pgtx, sign, dtype), psi)
    assert plan_for(pmesh.v2e) is not None
    assert not benes.DECLINES.since(cursor)
    monkeypatch.setattr(config, "AFFINE_GATHER", False)
    monkeypatch.setattr(config, "SORT_GATHER", False)
    index_mesh = make_mesh(pt)
    (g_index,) = _grad(_fvm_energy(index_mesh, pgtx, sign, dtype), psi)
    assert plan_for(index_mesh.v2e) is None
    return g, g_index, g_jax


def test_next_grad_through_affine_gather(monkeypatch):
    """grid_mesh(64), float64: the gradient with the affine plans engaged is
    bitwise the index path's (both are the same linear gather) and equals
    the JAX package's."""
    g, g_index, g_jax = _fvm_grads(lambda m: m.grid_mesh(64), np.float64, monkeypatch,
                                   affine_remap.plan_for)
    np.testing.assert_array_equal(g, g_index)
    np.testing.assert_allclose(g, g_jax, **TOL)


def test_next_grad_through_sort_routed_gather(monkeypatch):
    """shuffled_mesh(200, 7), float32: each permutation of the routed
    gathers is differentiated through the inverse permutation on the same
    network (six forward and six backward runs of the butterfly); the
    gradient equals the JAX package's and the index path's at rtol 1e-5."""
    runs = []
    real = benes._run
    monkeypatch.setattr(benes, "_run", lambda v, p: runs.append(p) or real(v, p))
    g, g_index, g_jax = _fvm_grads(lambda m: m.shuffled_mesh(200, seed=7), np.float32,
                                   monkeypatch, sort_route.plan_for)
    assert len(runs) == 12
    assert {id(p) for p in runs[6:]} == {id(p.inverse) for p in runs[:6]}
    np.testing.assert_allclose(g, g_jax, rtol=1e-5, atol=0)
    np.testing.assert_allclose(g, g_index, rtol=1e-5, atol=0)


def test_permute_differentiates_in_both_modes():
    """``benes.permute``'s gradient is the cotangent permuted by sigma^-1,
    its tangent the tangent permuted by sigma; without a derivative wanted
    it returns a plain tensor."""
    P = 1000
    sigma = np.random.default_rng(5).permutation(P)
    keys = np.empty(P, dtype=np.int32)
    keys[sigma] = np.arange(P)
    x = torch.from_numpy(np.random.default_rng(6).random(P).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(7).random(P).astype(np.float32))
    leaf = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((benes.permute(leaf, keys) * w).sum(), leaf)
    expect = torch.empty_like(w)
    expect[torch.from_numpy(sigma)] = w
    assert torch.equal(g, expect)
    _, tang = torch.func.jvp(lambda a: benes.permute(a, keys), (x,), (w,))
    assert torch.equal(tang, w[torch.from_numpy(sigma)])
    assert benes.permute(x, keys).grad_fn is None


# --------------------------------------------------------------------------- #
# K8's plumbing on the emulated kernels
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_emulated_kernels_vs_plain(emulated, name):  # noqa: F811
    """The forward on the generated kernels (one launch per call, each
    under K8), the derivatives from the plain executor: bitwise those of
    the plain executor alone (the card's leg: ``test_k8_kernels_vs_plain``)."""
    start = k8_counts(K8_CASES[name][0](np.float64, backend="cuda"))
    st, *got = k8_derivatives(name, "cuda", "cpu")
    _, *ref = k8_derivatives(name, "torch", "cpu")
    assert k8_counts(st, start) == (3, 3)
    grads, value, tang, tang_fw = got
    for a, b in zip(grads, ref[0]):
        assert torch.equal(a, b)
        assert a.abs().max() > 0
    assert torch.equal(value, ref[1]) and torch.equal(tang, ref[2])
    assert torch.equal(tang_fw, ref[3]) and float(tang) != 0


def test_k8_engages_only_for_derivatives(emulated):  # noqa: F811
    """No grad mode, or no input that requires grad: the kernels run as for
    serving (one launch, K8 not engaged), with the same values."""
    st, run, _ = k8_call("vadv_update", "cuda", "cpu")
    start = k8_counts(st)
    bufs = _buffers(np.float64, "cpu", seed=7)
    plain = run(bufs)
    assert k8_counts(st, start) == (1, 0)
    with torch.no_grad():
        assert torch.equal(run({**bufs, "u": bufs["u"].clone().requires_grad_()}), plain)
    assert k8_counts(st, start) == (2, 0)
    loss = run({**bufs, "u": bufs["u"].clone().requires_grad_()})
    assert loss.requires_grad and torch.equal(loss.detach(), plain)
    assert k8_counts(st, start) == (3, 1)


def test_k8_launch_failure_raises(monkeypatch):
    """With a derivative wanted the primal still comes from the kernels: a
    failed launch raises, and nothing computes it with the plain executor
    instead."""
    st, run, _ = k8_call("hdiff", "cuda", "cpu")

    def fail(*args):
        raise RuntimeError("CUDA launch failed in stencil 'hdiff'")

    monkeypatch.setattr(st.backend, "_launch", fail)
    monkeypatch.setattr(cuda_backend.CudaBackend, "apply", cuda_backend.CudaBackend.run_kernels)
    bufs = _buffers(np.float64, "cpu", seed=7)
    with pytest.raises(RuntimeError, match="launch failed"):
        run({**bufs, "u": bufs["u"].clone().requires_grad_()})


def test_k8_emulated_next_operator(emulated):  # noqa: F811
    """The bridge's kernels under K8: the gradient of a next operator on
    ``"cuda"`` (the emulated kernels) equals the embedded one bitwise."""
    data = np.random.default_rng(0).random((10, 6, 4))
    ops = {backend: POPS["bridge_op"].with_backend(backend) for backend in BACKENDS}
    got = {}
    for backend, op in ops.items():
        before = [(k.launches, k.derivative_calls) for k in cuda_bridge.kernels_of(op)]
        (got[backend],) = _grad(lambda x: (op(_pfield("IJK", x)).data ** 2).sum(), data)
    kern = cuda_bridge.kernels_of(ops["cuda"])
    before = before or [(0, 0)] * len(kern)
    assert kern
    assert [(k.launches - a, k.derivative_calls - b)
            for k, (a, b) in zip(kern, before)] == [(1, 1)] * len(kern)
    np.testing.assert_array_equal(got["cuda"], got["torch"])
