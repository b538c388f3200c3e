"""Test helpers for the port's next DSL.

- ``fields_from_numpy`` carries the same numpy arrays (made from a seed)
  into the port, so a test hands identical numbers to
  ``gt4py_tpu.next.as_field`` and to the port and compares the results.
- ``bench_cases`` builds bench.py's next-DSL configurations on a device,
  for the chip check and the card tests (where JAX is absent).

(No ``from __future__ import annotations`` here: the operators defined
inside ``bench_cases`` annotate with a local dtype, which the frontend
must see as a value, not as a string.)
"""

import contextlib
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from gt4py_tpu_torch import config

from .common import Dimension, Domain, Field, UnitRange as U
from .constructors import as_field


def fields_from_numpy(arrays: Mapping[str, np.ndarray],
                      dims: Union[Sequence[Dimension], Mapping[str, Sequence[Dimension]]],
                      device, origin: Optional[Mapping[Dimension, int]] = None
                      ) -> Dict[str, Field]:
    """``{name: Field}`` over copies of ``arrays`` on ``device`` (torch
    tensors in the constructors' layout).  ``dims``: one dims tuple for
    every array, or a mapping from name to dims."""
    out = {}
    for name, a in arrays.items():
        d = dims[name] if isinstance(dims, Mapping) else dims
        out[name] = as_field(tuple(d), np.asarray(a), origin=origin, device=device)
    return out


@contextlib.contextmanager
def program_fusion(flag):
    """``config.PROGRAM_FUSION`` set to ``flag`` (unchanged for None)."""
    old = config.PROGRAM_FUSION
    if flag is not None:
        config.PROGRAM_FUSION = flag
    try:
        yield
    finally:
        config.PROGRAM_FUSION = old


def bench_cases(dtype, shape, device):
    """bench.py's next-DSL configurations (``bench_tpu_next_hdiff_pallas``,
    ``_hdiff_program``, ``_mixed_program``, ``_tridiag``: the same
    operators, geometry and seeds) at ``shape`` = (NI, NJ, NK) on
    ``device``, for the chip check and the card tests: name ->
    ``{"run": backend -> {output: tensor}, "objs": the cuda-backed
    operators and programs, "fusion": PROGRAM_FUSION for the run,
    "kernels": plan the cuda run and return its kernel wrappers}``.
    ``run("cuda")`` and ``run("torch")`` write preallocated outputs, so
    repeated calls do the same work."""
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dims, Field, program, where

    NI, NJ, NK = shape
    OI, OJ = 8, 128
    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    T = gtx.float32 if np.dtype(dtype) == np.float32 else gtx.float64
    FT = Field[Dims[I, J, K], T]

    @gtx.field_operator
    def hdiff(inp: FT, coeff: FT) -> FT:
        lap = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
        flx = lap(Ioff[1]) - lap
        flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
        fly = lap(Joff[1]) - lap
        fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
        return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))

    @gtx.field_operator
    def lap_op(inp: FT) -> FT:
        return 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))

    @gtx.field_operator
    def flx_op(inp: FT, lap: FT) -> FT:
        fx = lap(Ioff[1]) - lap
        return where(fx * (inp(Ioff[1]) - inp) > 0.0, 0.0, fx)

    @gtx.field_operator
    def fly_op(inp: FT, lap: FT) -> FT:
        fy = lap(Joff[1]) - lap
        return where(fy * (inp(Joff[1]) - inp) > 0.0, 0.0, fy)

    @gtx.field_operator
    def out_op(inp: FT, fx: FT, fy: FT, coeff: FT) -> FT:
        return inp - coeff * (fx - fx(Ioff[-1]) + fy - fy(Joff[-1]))

    @program
    def hdiff_prog(inp: FT, coeff: FT, lap: FT, fx: FT, fy: FT, res: FT):
        lap_op(inp, out=lap)
        flx_op(inp, lap, out=fx)
        fly_op(inp, lap, out=fy)
        out_op(inp, fx, fy, coeff, out=res)

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def integ(carry: T, x: T) -> T:
        return carry * 0.9 + x

    @gtx.field_operator
    def upd(inp: FT, acc: FT) -> FT:
        return inp - 0.1 * acc

    @program
    def mixed_prog(inp: FT, lap: FT, acc: FT, res: FT):
        lap_op(inp, out=lap)
        integ(lap, out=acc)
        upd(inp, acc, out=res)

    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def tri_fwd(carry: tuple[T, T], a: T, b: T, c: T, d: T):
        denom = b - a * carry[0]
        cp = c / denom
        dp = (d - a * carry[1]) / denom
        return (cp, dp)

    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def tri_bwd(carry: T, cp: T, dp: T) -> T:
        return dp - cp * carry

    def fld(dom, arr):
        return gtx.as_field(dom, arr, device=device)

    def zeros(dom):
        return gtx.zeros(dom, dtype, device=device)

    cases = {}
    # -- hdiff field operator, out= and domain= (16 = 2 x halo + slack) --
    SI, SJ = OI + NI + 16, OJ + NJ + 128
    rng = np.random.default_rng(5)
    inp_np = rng.random((SI, SJ, NK)).astype(dtype)
    coeff_np = (0.025 * rng.random((SI, SJ, NK))).astype(dtype)
    full = Domain((I, J, K), (U(0, SI), U(0, SJ), U(0, NK)))
    interior = Domain((I, J, K), (U(OI, OI + NI), U(OJ, OJ + NJ), U(0, NK)))
    inp, coeff = fld(full, inp_np), fld(full, coeff_np)
    ops = {b: hdiff.with_backend(b) for b in ("cuda", "torch")}
    outs = {b: zeros(full) for b in ops}

    def run_hdiff(b, args=(inp, coeff)):
        ops[b](*args, out=outs[b], domain=interior)
        return {"res": outs[b].data}

    cases["hdiff"] = dict(run=run_hdiff, objs=[ops["cuda"]], fusion=None,
                          kernels=lambda: ops["cuda"].kernels(inp, coeff))
    # the same fields K-contiguous: a C-order (I, J, K) tensor taken as it is
    inp_k = gtx.as_field(full, torch.from_numpy(inp_np).to(device))
    coeff_k = gtx.as_field(full, torch.from_numpy(coeff_np).to(device))
    cases["hdiff_kcontig"] = dict(
        run=lambda b: run_hdiff(b, (inp_k, coeff_k)), objs=[ops["cuda"]], fusion=None,
        kernels=lambda: [])

    # -- the four-statement hdiff program, fused and statement-wise --
    def halo(ilo, ihi, jlo, jhi):
        return Domain((I, J, K), (U(OI - ilo, OI + NI + ihi), U(OJ - jlo, OJ + NJ + jhi),
                                  U(0, NK)))

    doms = dict(lap=halo(1, 1, 1, 1), fx=halo(1, 0, 0, 0), fy=halo(0, 0, 1, 0),
                res=halo(0, 0, 0, 0))
    for fused in (True, False):
        progs = {b: hdiff_prog.with_backend(b) for b in ("cuda", "torch")}
        pouts = {b: {n: zeros(d) for n, d in doms.items()} for b in progs}

        def run_prog(b, progs=progs, pouts=pouts):
            o = pouts[b]
            progs[b](inp, coeff, o["lap"], o["fx"], o["fy"], o["res"])
            return {n: f.data for n, f in o.items()}

        cases[f"hdiff_prog_{'fused' if fused else 'statementwise'}"] = dict(
            run=run_prog, objs=[progs["cuda"]], fusion=fused,
            kernels=lambda p=progs["cuda"], o=pouts["cuda"]: p.kernels(
                inp, coeff, o["lap"], o["fx"], o["fy"], o["res"]))

    # -- lap -> integ scan -> upd, fused and statement-wise --
    MI, MJ = OI + NI + 8, OJ + NJ + 128
    rng = np.random.default_rng(9)
    minp = fld(Domain((I, J, K), (U(0, MI), U(0, MJ), U(0, NK))),
               rng.random((MI, MJ, NK)).astype(dtype))
    for fused in (True, False):
        progs = {b: mixed_prog.with_backend(b) for b in ("cuda", "torch")}
        mouts = {b: {n: zeros(interior) for n in ("lap", "acc", "res")} for b in progs}

        def run_mixed(b, progs=progs, mouts=mouts):
            o = mouts[b]
            progs[b](minp, o["lap"], o["acc"], o["res"])
            return {n: f.data for n, f in o.items()}

        cases[f"mixed_prog_{'fused' if fused else 'statementwise'}"] = dict(
            run=run_mixed, objs=[progs["cuda"]], fusion=fused,
            kernels=lambda p=progs["cuda"], o=mouts["cuda"]: p.kernels(
                minp, o["lap"], o["acc"], o["res"]))

    # -- tridiagonal solve: tuple-carry forward scan, backward scan --
    rng = np.random.default_rng(9)
    box = Domain((I, J, K), (U(0, NI), U(0, NJ), U(0, NK)))
    a, b_, c = (fld(box, rng.random((NI, NJ, NK)).astype(dtype) + off)
                for off in (0.0, 4.0, 0.0))
    d = fld(box, rng.random((NI, NJ, NK)).astype(dtype))
    fwds = {b: tri_fwd.with_backend(b) for b in ("cuda", "torch")}
    bwds = {b: tri_bwd.with_backend(b) for b in ("cuda", "torch")}

    def run_tri(b):
        cp, dp = fwds[b](a, b_, c, d)
        return {"x": bwds[b](cp, dp).data}

    cases["tridiag"] = dict(
        run=run_tri, objs=[fwds["cuda"], bwds["cuda"]], fusion=None,
        kernels=lambda: fwds["cuda"].kernels(a, b_, c, d) + bwds["cuda"].kernels(a, b_))
    for case in cases.values():
        planner = case["kernels"]

        def planned(planner=planner, fusion=case["fusion"]):
            with program_fusion(fusion):
                return planner()

        case["kernels"] = planned
    return cases
