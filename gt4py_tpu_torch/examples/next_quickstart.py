"""The next field-view DSL's quickstart on the card (the JAX package's
``examples/next_quickstart.py``): operators, scans, ``concat_where``,
programs and the compiled ``"cuda"`` backend.  Every step checks its
result against the numpy oracle, and the compiled steps assert that they
took the kernel path (no fallback recorded, the libraries' launches
counted).

    python -m gt4py_tpu_torch.examples.next_quickstart [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch.examples import cli, counted, launches
from gt4py_tpu_torch.next import backends, concat_where, cuda_bridge, program, where

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
    interior = 0.5 * (t(Koff[-1]) + t)  # reads K-1: only legal for K >= 1
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


N, M, NK = 32, 24, 12


def _kernel_path(fn):
    """``fn()`` on the ``"cuda"`` backend: no fallback recorded, and on
    the card the libraries counted a launch."""
    cur = cuda_bridge.FALLBACK_EVENTS.cursor()
    before = launches()
    out = fn()
    assert not cuda_bridge.FALLBACK_EVENTS.since(cur), cuda_bridge.FALLBACK_EVENTS.since(cur)
    if _on_card(out):
        assert launches() > before, "no kernel launched"
    return out


def _on_card(x) -> bool:
    data = x[0].data if isinstance(x, list) else x.data
    return isinstance(data, torch.Tensor) and data.device.type == "cuda"


def main(device=None) -> dict:
    """The quickstart's six steps on ``device``; returns the numbers it
    prints (each step's largest difference from the oracle, the sums of
    its results, and the gradient's)."""
    dev = config.resolve_device(device)
    rng = np.random.default_rng(0)
    U = gtx.UnitRange
    out: dict = {"device": str(dev)}

    def fld(ilo, ihi, jlo, jhi, data=None):
        dom = gtx.Domain((I, J, K), (U(ilo, N + ihi), U(jlo, M + jhi), U(0, NK)))
        shape = tuple(len(r) for r in dom.ranges)
        arr = rng.random(shape) if data is None else np.zeros(shape)
        return gtx.as_field(dom, arr, device=dev)

    def err(a, b):
        return float(np.abs(a.asnumpy() - b.asnumpy()).max())

    with counted(dev) as count:
        # 1. a field operator; domains shrink by the read extents
        a = fld(-2, 2, -2, 2)
        r = lap(a)  # embedded execution on the arguments' device
        assert r.domain[I].start == -1 and r.domain[I].stop == N + 1
        out["lap_domain"] = [(d.value, (rr.start, rr.stop)) for d, rr in r.domain]
        print("1. lap domain:", out["lap_domain"])

        # 2. backends: the oracle against the compiled kernels
        ref = lap.with_backend(backends.numpy_oracle)(a)
        fast = _kernel_path(lambda: lap.with_backend("cuda")(a))
        np.testing.assert_allclose(fast.asnumpy(), ref.asnumpy(), rtol=1e-13)
        out["lap"] = fast.asnumpy()
        out["lap_err"], out["lap_sum"] = err(fast, ref), float(out["lap"].sum())
        print("2. cuda == oracle, zero fallbacks")

        # 3. a scan operator (column physics): the column kernel
        c_ref = damped_sum.with_backend(backends.numpy_oracle)(a)
        c_par = _kernel_path(lambda: damped_sum.with_backend("cuda")(a))
        np.testing.assert_allclose(c_par.asnumpy(), c_ref.asnumpy(), rtol=1e-13)
        out["scan"] = c_par.asnumpy()
        out["scan_err"], out["scan_sum"] = err(c_par, c_ref), float(out["scan"].sum())
        print("3. scan operator: column kernel == oracle")

        # 4. concat_where: boundary conditions without out-of-bounds reads
        t, sfc = fld(0, 0, 0, 0), fld(0, 0, 0, 0)
        b_ref = column_bc.with_backend(backends.numpy_oracle)(t, sfc)
        b_par = _kernel_path(lambda: column_bc.with_backend("cuda")(t, sfc))
        np.testing.assert_allclose(b_par.asnumpy(), b_ref.asnumpy(), rtol=1e-13)
        out["bc"] = b_par.asnumpy()
        out["bc_err"], out["bc_sum"] = err(b_par, b_ref), float(out["bc"].sum())
        print("4. concat_where: K-sectioned kernel == oracle")

        # 5. a program: its operators fused into one stencil on "cuda"
        def run(backend):
            args = [fld(-2, 2, -2, 2, 1), fld(-1, 1, -1, 1, 1), fld(-1, 0, 0, 0, 1),
                    fld(0, 0, 0, 0, 1)]
            rng2 = np.random.default_rng(7)
            args[0] = gtx.as_field(args[0].domain, rng2.random(tuple(args[0].data.shape)),
                                   device=dev)
            diffuse.with_backend(backend)(*args, 0.1)
            return args

        ref_args = run(backends.numpy_oracle)
        par_args = _kernel_path(lambda: run("cuda"))
        for nm, rr, pp in zip(("lap", "fx", "out"), ref_args[1:], par_args[1:]):
            np.testing.assert_allclose(pp.asnumpy(), rr.asnumpy(), rtol=1e-12, err_msg=nm)
        out["program_err"] = max(err(p, r) for p, r in zip(par_args[1:], ref_args[1:]))
        out["program_out"] = par_args[3].asnumpy()
        out["program_out_sum"] = float(out["program_out"].sum())
        print("5. program fusion: every buffer (incl. halo-extended lap) == oracle")

        # 6. autodiff through the compiled kernels (torch.autograd, K8)
        bound = lap.with_backend("cuda")
        x = a.data.detach().clone().requires_grad_(True)
        loss = (bound(gtx.Field(a.domain, x)).data ** 2).sum()
        (g,) = torch.autograd.grad(loss, x)
        out["grad"] = g.detach().cpu().numpy()
        out["grad_shape"] = list(g.shape)
        out["grad_norm"] = float(g.double().norm())
        print("6. grad through the kernel:", tuple(g.shape), "ok")
    out.update(count)
    print("\nquickstart complete")
    return out


if __name__ == "__main__":
    cli(main)
