"""A guided tour of the cartesian GTScript DSL on the card (the JAX
package's ``examples/cartesian_tutorial.py``, cell by cell).

    python -m gt4py_tpu_torch.examples.cartesian_tutorial [--cpu]

You write a Python function over 3D fields; ``@gtscript.stencil`` parses
it once into a validated stencil IR (race rules, dtype resolution, extent
analysis) and hands it to a backend: ``numpy`` (the oracle that defines
the numerics) and ``debug`` (plain loops) on the host, ``torch`` (the
plain PyTorch executor, on any device) and ``cuda`` (generated CUDA
kernels for the H100).  All backends agree to 1e-12 in float64.
"""

from __future__ import annotations

import numpy as np

from gt4py_tpu_torch import config, storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)
from gt4py_tpu_torch.examples import cli, counted

Field = gtscript.Field[np.float64]


def copy_defn(src: Field, dst: Field):
    with computation(PARALLEL), interval(...):
        dst = src


def laplacian_defn(u: Field, lap: Field):
    with computation(PARALLEL), interval(...):
        lap = -4.0 * u[0, 0, 0] + u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]


def hdiff_defn(inp: Field, out: Field, coeff: Field):
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


def tridiag_defn(a: Field, b: Field, c: Field, d: Field, x: Field):
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


#: the backends of cell 6: the host ones run on CPU fields
BACKENDS = ("numpy", "debug", "torch", "cuda")
HOST_BACKENDS = ("numpy", "debug")


def main(device=None, backend: str = "cuda") -> dict:
    """The tutorial's cells on ``device`` (the card by default); cells 1
    to 5 on ``backend``.  Returns the numbers it prints."""
    from gt4py_tpu_torch.cartesian.backend.cuda_backend import LAST_PLAN

    dev = config.resolve_device(device)
    out: dict = {"device": str(dev)}
    with counted(dev) as count:
        # cell 1: the smallest stencil.  computation(PARALLEL): every
        # statement is a whole-domain parallel assignment
        copy = gtscript.stencil(backend=backend, name="tut_copy")(copy_defn)
        a = storage.from_array(np.random.default_rng(1).random((8, 8, 4)), device=dev)
        b = storage.zeros((8, 8, 4), device=dev)
        copy(a, b)
        assert np.array_equal(a.to_numpy(), b.to_numpy())
        print("cell 1: copy stencil OK")

        # cell 2: offsets, halos, origins.  u[1, 0, 0] reads the I+1
        # neighbour: fields need a halo, and origin says where the
        # compute domain starts inside each buffer
        laplacian = gtscript.stencil(backend=backend, name="tut_laplacian")(laplacian_defn)
        n = 10
        u_np = np.fromfunction(lambda i, j, k: i * i + j, (n, n, 3))
        u = storage.from_array(u_np, device=dev, aligned_index=(1, 1, 0))
        lap = storage.zeros((n, n, 3), device=dev, aligned_index=(1, 1, 0))
        laplacian(u, lap, origin=(1, 1, 0), domain=(n - 2, n - 2, 3))
        interior = lap.to_numpy()[1:-1, 1:-1, :]
        assert np.allclose(interior, 2.0)  # d2/di2 + d2/dj2 of i^2 + j
        out["laplacian_interior"] = float(interior.mean())
        print("cell 2: laplacian with halo/origin OK")

        # cell 3: the parse result is inspectable
        info = str(laplacian)
        assert "u" in info and "lap" in info
        assert "computation(PARALLEL)" in laplacian.lowered(format="ir")
        out["boundary_u"] = [list(x) for x in laplacian.field_info["u"].boundary]
        print("cell 3: extent analysis says boundary(u) =", laplacian.field_info["u"].boundary)

        # cell 4: temporaries: the extent analysis computes the halo each
        # stage needs (the horizontal diffusion pattern)
        hdiff = gtscript.stencil(backend=backend, name="tut_hdiff")(hdiff_defn)
        h = 2
        shape = (16 + 2 * h, 16 + 2 * h, 4)
        rng = np.random.default_rng(0)
        inp = storage.from_array(rng.random(shape), device=dev, aligned_index=(h, h, 0))
        outp = storage.zeros(shape, device=dev, aligned_index=(h, h, 0))
        cf = storage.from_array(0.05 * rng.random(shape), device=dev, aligned_index=(h, h, 0))
        hdiff(inp, outp, cf, origin=(h, h, 0), domain=(16, 16, 4))
        out["hdiff_out"] = outp.to_numpy()
        out["hdiff_sum"] = float(out["hdiff_out"][h:-h, h:-h].sum())
        print("cell 4: hdiff with temporaries OK")

        # cell 5: sequential K: the Thomas algorithm
        tridiag = gtscript.stencil(backend=backend, name="tut_tridiag")(tridiag_defn)
        nk = 30
        sh = (4, 4, nk)
        A, B, C = (storage.from_array(np.full(sh, v), device=dev) for v in (-1.0, 2.6, -1.0))
        D = storage.from_array(rng.random(sh), device=dev)
        X = storage.zeros(sh, device=dev)
        tridiag(A, B, C, D, X, origin=(0, 0, 0), domain=sh)
        x = X.to_numpy()
        res = B.to_numpy() * x
        res[:, :, 1:] += A.to_numpy()[:, :, 1:] * x[:, :, :-1]
        res[:, :, :-1] += C.to_numpy()[:, :, :-1] * x[:, :, 1:]
        out["tridiag_residual"] = float(np.abs(res - D.to_numpy()).max())
        out["tridiag_x"], out["tridiag_x_sum"] = x, float(x.sum())
        assert out["tridiag_residual"] < 1e-12
        print("cell 5: tridiagonal solve residual < 1e-12")

        # cell 6: the same definition on every backend; numpy is the
        # oracle, cuda the kernels
        results = {}
        for bk in BACKENDS:
            st = gtscript.stencil(backend=bk, name=f"tut_lap_{bk}")(laplacian_defn)
            where = "cpu" if bk in HOST_BACKENDS else dev
            uu = storage.from_array(u_np, device=where, aligned_index=(1, 1, 0))
            ll = storage.zeros((n, n, 3), device=where, aligned_index=(1, 1, 0))
            st(uu, ll, origin=(1, 1, 0), domain=(n - 2, n - 2, 3))
            results[bk] = ll.to_numpy()
            if bk == "cuda" and dev.type == "cuda":
                # the kernel path: the plan and the library's count
                assert LAST_PLAN[st.name]["forms"] and st.backend.launches >= 1
        for bk, got in results.items():
            np.testing.assert_allclose(got, results["numpy"], rtol=1e-12, err_msg=bk)
        out["backends_max_diff"] = max(float(np.abs(g - results["numpy"]).max())
                                       for g in results.values())
        print("cell 6: all four backends agree to 1e-12")

        # cell 7: instrumentation: per-call times in exec_info, the cuda
        # backend's plan per stencil in LAST_PLAN
        exec_info: dict = {}
        copy(a, b, exec_info=exec_info)
        assert exec_info["call_run_end_time"] >= exec_info["call_run_start_time"]
        out["exec_info_keys"] = sorted(k for k in exec_info if k.endswith("time"))
        print("cell 7: exec_info keys:", out["exec_info_keys"])
        print("        cuda plan of tut_lap_cuda:", LAST_PLAN["tut_lap_cuda"]["forms"])
    out.update(count)
    print("tutorial complete")
    return out


if __name__ == "__main__":
    cli(main)
