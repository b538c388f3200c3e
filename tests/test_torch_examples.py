"""The port's examples (``gt4py_tpu_torch.examples``) on the CPU, each run
as its command (``python -m gt4py_tpu_torch.examples.<name> --cpu``, all
six at once), its numbers held against the same numbers from the JAX
package on the same seeded inputs: at rtol = atol = 1e-12 in float64, and
at rtol 1e-5 / atol 1e-6 for the two float32 examples (the distributed
MiniDycore's five steps and the distributed field operators)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gt4py_tpu_torch.examples import EXAMPLES

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's last line (its numbers) and saved arrays."""
    d = tmp_path_factory.mktemp("examples")
    procs = {}
    for name in EXAMPLES:
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                   GT4PY_TPU_TORCH_EXAMPLE_ARRAYS=str(d / f"{name}.npz"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"gt4py_tpu_torch.examples.{name}", "--cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr, d / f"{name}.npz")
    return out


def numbers(runs, name):
    rc, stdout, stderr, npz = runs[name]
    assert rc == 0, f"{name} failed:\n{stdout[-2000:]}\n{stderr[-3000:]}"
    got = json.loads(stdout.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["device_kernels"] is None, got
    with np.load(npz) as arrays:
        got.update({k: arrays[k] for k in arrays.files})
    return got


def test_cartesian_tutorial(runs):
    """The tutorial's results: hdiff and the Thomas solve on the JAX
    package's numpy backend, the Laplacian's interior, the extent
    analysis' boundary, every backend equal."""
    from gt4py_tpu import storage
    from gt4py_tpu.cartesian import gtscript
    from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

    got = numbers(runs, "cartesian_tutorial")
    Field = gtscript.Field[np.float64]

    @gtscript.stencil(backend="numpy")
    def hdiff(inp: Field, out: Field, coeff: Field):
        with computation(PARALLEL), interval(...):
            lap_t = 4.0 * inp[0, 0, 0] - (
                inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
            )
            res1 = lap_t[1, 0, 0] - lap_t[0, 0, 0]
            flx = 0 if (res1 * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res1
            res2 = lap_t[0, 1, 0] - lap_t[0, 0, 0]
            fly = 0 if (res2 * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res2
            out = inp[0, 0, 0] - coeff[0, 0, 0] * (
                flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
            )

    @gtscript.stencil(backend="numpy")
    def tridiag(a: Field, b: Field, c: Field, d: Field, x: Field):
        with computation(FORWARD):
            with interval(0, 1):
                cp = c / b
                dp = d / b
            with interval(1, None):
                cp = c / (b - cp[0, 0, -1] * a)
                dp = (d - dp[0, 0, -1] * a) / (b - cp[0, 0, -1] * a)
        with computation(BACKWARD):
            with interval(-1, None):
                x = dp
            with interval(0, -1):
                x = dp - cp * x[0, 0, 1]

    h = 2
    shape = (16 + 2 * h, 16 + 2 * h, 4)
    rng = np.random.default_rng(0)
    inp = storage.from_array(rng.random(shape), backend="numpy", aligned_index=(h, h, 0))
    outp = storage.zeros(shape, backend="numpy", aligned_index=(h, h, 0))
    cf = storage.from_array(0.05 * rng.random(shape), backend="numpy", aligned_index=(h, h, 0))
    hdiff(inp, outp, cf, origin=(h, h, 0), domain=(16, 16, 4))
    np.testing.assert_allclose(got["hdiff_out"], np.asarray(outp), **F64)
    sh = (4, 4, 30)
    mk = lambda arr: storage.from_array(arr, backend="numpy")  # noqa: E731
    X = storage.zeros(sh, backend="numpy")
    tridiag(mk(np.full(sh, -1.0)), mk(np.full(sh, 2.6)), mk(np.full(sh, -1.0)),
            mk(rng.random(sh)), X, origin=(0, 0, 0), domain=sh)
    np.testing.assert_allclose(got["tridiag_x"], np.asarray(X), **F64)
    assert got["tridiag_residual"] < 1e-12 and got["backends_max_diff"] <= 1e-12
    assert got["laplacian_interior"] == 2.0 and got["boundary_u"] == [[1, 1], [1, 1], [0, 0]]


def test_laplacian_cartesian_vs_next(runs):
    """Both frontends' Laplacians of the 128^3 draw: their sums equal the
    JAX package's cartesian Laplacian's (numpy backend)."""
    from gt4py_tpu import storage
    from gt4py_tpu.cartesian import gtscript
    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    got = numbers(runs, "laplacian_cartesian_vs_next")
    Field3D = gtscript.Field[np.float64]

    @gtscript.stencil(backend="numpy")
    def lap_cartesian(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = -4.0 * inp + (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])

    n = got["n"]
    data = np.random.default_rng(0).random((n, n, n))
    inp = storage.from_array(data, backend="numpy", aligned_index=(1, 1, 0))
    out = storage.zeros((n, n, n), backend="numpy", aligned_index=(1, 1, 0))
    lap_cartesian(inp, out)
    ref = float(np.asarray(out)[1:-1, 1:-1, :].sum())
    assert n == 128 and got["max_abs_diff"] <= 1e-12
    np.testing.assert_allclose([got["cartesian_sum"], got["next_sum"]], [ref, ref], **F64)


def test_next_quickstart(runs):
    """Every step's result equals the JAX package's numpy oracle on the
    same draws, and the gradient through the kernels equals ``jax.grad``
    through the JAX package's embedded operator."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import backends, concat_where, program, where

    got = numbers(runs, "next_quickstart")
    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    Koff = gtx.FieldOffset("Koff", source=K, target=(K,))
    F = gtx.Field[[I, J, K], gtx.float64]

    @gtx.field_operator
    def lap(a: F) -> F:
        return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def damped_sum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry * 0.8 + x

    @gtx.field_operator
    def column_bc(t: F, sfc: F) -> F:
        interior = 0.5 * (t(Koff[-1]) + t)
        return concat_where(K < 1, sfc * 1.0, interior)

    @gtx.field_operator
    def flux_limited(a: F, lp: F) -> F:
        fx = lp(Ioff[1]) - lp
        return where(fx * (a(Ioff[1]) - a) > 0.0, 0.0, fx)

    @gtx.field_operator
    def update(a: F, fx: F, coeff: gtx.float64) -> F:
        return a - coeff * (fx - fx(Ioff[-1]))

    @program
    def diffuse(a: F, lp: F, fx: F, out: F, coeff: gtx.float64):
        lap(a, out=lp)
        flux_limited(a, lp, out=fx)
        update(a, fx, coeff, out=out)

    n, m, nk = 32, 24, 12
    rng = np.random.default_rng(0)
    U = gtx.UnitRange

    def fld(ilo, ihi, jlo, jhi, data=None):
        dom = gtx.Domain((I, J, K), (U(ilo, n + ihi), U(jlo, m + jhi), U(0, nk)))
        shape = tuple(len(r) for r in dom.ranges)
        return gtx.Field(dom, rng.random(shape) if data is None else np.zeros(shape))

    oracle = backends.numpy_oracle
    a = fld(-2, 2, -2, 2)
    np.testing.assert_allclose(got["lap"], lap.with_backend(oracle)(a).asnumpy(), **F64)
    np.testing.assert_allclose(got["scan"], damped_sum.with_backend(oracle)(a).asnumpy(), **F64)
    t, sfc = fld(0, 0, 0, 0), fld(0, 0, 0, 0)
    np.testing.assert_allclose(got["bc"], column_bc.with_backend(oracle)(t, sfc).asnumpy(),
                               **F64)
    args = [fld(-2, 2, -2, 2, 1), fld(-1, 1, -1, 1, 1), fld(-1, 0, 0, 0, 1), fld(0, 0, 0, 0, 1)]
    args[0] = gtx.Field(args[0].domain, np.random.default_rng(7).random(args[0].data.shape))
    diffuse.with_backend(oracle)(*args, 0.1)
    np.testing.assert_allclose(got["program_out"], args[3].asnumpy(), **F64)
    assert max(got[k] for k in ("lap_err", "scan_err", "bc_err", "program_err")) <= 1e-12
    assert got["lap_domain"] == [["I", [-1, n + 1]], ["J", [-1, m + 1]], ["K", [0, nk]]]
    g = jax.grad(lambda x: jnp.sum(lap(gtx.Field(a.domain, x)).data ** 2))(
        jnp.asarray(a.data))
    np.testing.assert_allclose(got["grad"], np.asarray(g), **F64)


def test_unstructured_fvm(runs):
    """The gradient, divergence and two-hop chain equal the JAX package's
    operators on its SimpleMesh."""
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, FieldOffset, neighbor_sum
    from gt4py_tpu.next.testing import E2VDim, Edge, SimpleMesh, V2EDim, Vertex

    got = numbers(runs, "unstructured_fvm")
    mesh = SimpleMesh.make()
    E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
    V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
    f64 = gtx.float64

    @gtx.field_operator
    def gradient(psi: Field[Dims[Vertex], f64]) -> Field[Dims[Edge], f64]:
        return psi(E2V[1]) - psi(E2V[0])

    @gtx.field_operator
    def divergence(flux: Field[Dims[Edge], f64],
                   sign: Field[Dims[Vertex, V2EDim], f64]) -> Field[Dims[Vertex], f64]:
        return neighbor_sum(flux(V2E) * sign, axis=V2EDim)

    @gtx.field_operator
    def second_ring(v: Field[Dims[Vertex], f64]) -> Field[Dims[Vertex], f64]:
        return v(E2V[0], V2E[1])

    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    xv, yv = np.meshgrid(np.arange(3.0), np.arange(3.0), indexing="xy")
    psi = gtx.as_field((Vertex,), (xv + 2 * yv).ravel())
    grad = gradient(psi, offset_provider=provider)
    t = mesh.v2e.table
    first = mesh.e2v.table[np.clip(t, 0, mesh.n_edges - 1), 0]
    sign = gtx.as_field((Vertex, V2EDim),
                        np.where(t == -1, 0.0, np.where(first == np.arange(9)[:, None], 1.0,
                                                        -1.0)))
    div = divergence(grad, sign, offset_provider=provider)
    ring = second_ring(psi, offset_provider=provider)
    for key, ref in (("gradient", grad), ("divergence", div), ("second_ring", ring)):
        np.testing.assert_allclose(got[key], ref.asnumpy(), **F64, err_msg=key)


def test_distributed_dycore(runs):
    """The four ranks' five sharded steps equal the JAX package's
    single-device periodic MiniDycore steps on the same draw (float32)."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.dycore import MiniDycore, periodic_fill
    from gt4py_tpu_torch.examples import distributed_dycore as ex

    got = numbers(runs, "distributed_dycore")
    nk, ni, nj = ex.NK, ex.BLOCK[0] * ex.MESH[0], ex.BLOCK[1] * ex.MESH[1]
    single = MiniDycore(ni, nj, nk, dtype=np.float32, backend="jax", aligned=False)
    h = MiniDycore.HALO
    buf = {}
    for k, v in ex.state((nk, ni, nj)).items():
        b = np.zeros(single.field_shape(), dtype=np.float32)
        b[:, h:h + ni, h:h + nj] = v
        buf[k] = jnp.asarray(b)
    step = single.step_fn(fill_halos=True)
    run = jax.jit(lambda s: step({k: periodic_fill(v, h, ni, nj) for k, v in s.items()}))
    for _ in range(5):
        buf = run(buf)
    ref = np.asarray(buf["u"])[:, h:h + ni, h:h + nj]
    assert got["shape"] == [nk, ni, nj] and got["finite"]
    np.testing.assert_allclose(got["u"], ref, **F32)
    np.testing.assert_allclose(got["mean"], ref.mean(dtype=np.float64), **F32)


def test_distributed_next(runs):
    """The four ranks' Laplacian into a column scan, gathered, equals the
    JAX package's numpy-backed operators on the same draw (float32)."""
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field
    from gt4py_tpu_torch.examples import distributed_next as ex

    got = numbers(runs, "distributed_next")
    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))

    @gtx.field_operator
    def laplacian(f: Field[Dims[I, J, K], gtx.float32]) -> Field[Dims[I, J, K], gtx.float32]:
        return f(Ioff[1]) + f(Ioff[-1]) + f(Joff[1]) + f(Joff[-1]) - 4.0 * f

    data = ex.data((ex.BLOCK[0] * ex.MESH[0], ex.BLOCK[1] * ex.MESH[1], ex.NK))
    ref = np.cumsum(laplacian(gtx.as_field((I, J, K), data, allocator="numpy")).asnumpy(),
                    axis=2, dtype=np.float32)
    np.testing.assert_allclose(got["out"], ref, **F32)
    assert got["ranges"] == [[1, 31], [1, 31], [0, 8]] and got["max_abs_err"] <= 2e-6
