"""Test helpers for the port's next DSL.

- ``fields_from_numpy`` carries the same numpy arrays (made from a seed)
  into the port, so a test hands identical numbers to
  ``gt4py_tpu.next.as_field`` and to the port and compares the results.
- ``bench_cases`` builds bench.py's next-DSL configurations on a device,
  for the chip check and the card tests (where JAX is absent).
- ``SimpleMesh``, ``grid_mesh``, ``shuffled_mesh`` and ``simple_mesh_case``
  are the JAX package's unstructured meshes (numpy neighbor tables, the
  same numbering and seeds); ``unstructured_fvm_case`` builds bench.py's
  unstructured FVM step on them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gt4py_tpu_torch import config

from .common import Connectivity, Dimension, DimensionKind, Domain, Field, UnitRange as U
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


# --------------------------------------------------------------------- #
# unstructured meshes (the JAX package's ``next.testing``; reference:
# cases.py SimpleMesh)
# --------------------------------------------------------------------- #

Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
Cell = Dimension("Cell")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)


@dataclasses.dataclass
class Case:
    """Default sizes per dimension and the offset provider of a mesh
    test; ``allocator`` is ``"numpy"`` (the oracle) or ``"torch"``."""

    default_sizes: Dict[Dimension, int]
    offset_provider: Dict[str, Any] = dataclasses.field(default_factory=dict)
    allocator: str = "numpy"

    def size(self, dim: Dimension) -> int:
        if dim not in self.default_sizes:
            raise KeyError(f"no default size for dimension {dim.value}")
        return self.default_sizes[dim]


@dataclasses.dataclass
class SimpleMesh:
    """A 9-vertex / 12-edge structured quad patch exposed as unstructured
    connectivity tables, with skip values on the boundary (interior
    vertices have 4 incident edges, corners only 2)."""

    n_vertices: int
    n_edges: int
    v2e: Connectivity
    e2v: Connectivity

    @classmethod
    def make(cls) -> "SimpleMesh":
        # 3x3 vertices, edges: 6 horizontal + 6 vertical
        e2v_table = np.array(
            [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8],
             [0, 3], [1, 4], [2, 5], [3, 6], [4, 7], [5, 8]],
            dtype=np.int64,
        )
        nv = 9
        v2e_lists: list = [[] for _ in range(nv)]
        for e, (a, b) in enumerate(e2v_table):
            v2e_lists[a].append(e)
            v2e_lists[b].append(e)
        width = max(len(l) for l in v2e_lists)
        v2e_table = np.full((nv, width), -1, dtype=np.int64)
        for v, l in enumerate(v2e_lists):
            v2e_table[v, : len(l)] = l
        return cls(nv, len(e2v_table), *_mesh_conns(v2e_table, e2v_table))


def _mesh_conns(v2e_table, e2v_table) -> Tuple[Connectivity, Connectivity]:
    return (
        Connectivity(v2e_table, source=Vertex, codomain=Edge, local_dim=V2EDim,
                     skip_value=-1),
        Connectivity(e2v_table, source=Edge, codomain=Vertex, local_dim=E2VDim,
                     skip_value=None),  # every edge has both endpoints
    )


def grid_mesh(n: int) -> SimpleMesh:
    """An n x n structured quad patch as unstructured connectivity tables
    (the SimpleMesh layout at any scale): 2*n*(n-1) edges, skip values at
    boundary vertices.  Its tables are quasi-structured: gathers through
    them plan as affine windows (``affine_remap``)."""
    nv = n * n
    vid = np.arange(nv).reshape(n, n)
    h = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1)
    v = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1)
    e2v_table = np.concatenate([h, v], axis=0).astype(np.int64)
    ne = len(e2v_table)
    # incident edges per vertex, skip-padded to width 4
    counts = np.zeros(nv, dtype=np.int64)
    v2e_table = np.full((nv, 4), -1, dtype=np.int64)
    for col in (0, 1):
        vs = e2v_table[:, col]
        order = np.argsort(vs, kind="stable")
        for e, vtx in zip(order, vs[order]):
            v2e_table[vtx, counts[vtx]] = e
            counts[vtx] += 1
    return SimpleMesh(nv, ne, *_mesh_conns(v2e_table, e2v_table))


def shuffled_mesh(n: int, seed: int = 0) -> SimpleMesh:
    """The :func:`grid_mesh` topology with vertices and edges renumbered by
    random permutations: the same physics, truly irregular tables (the
    affine fit declines), so gathers take the sort-routing path
    (``sort_route``, K9)."""
    mesh = grid_mesh(n)
    rng = np.random.default_rng(seed)
    pv = rng.permutation(mesh.n_vertices).astype(np.int64)  # old -> new
    pe = rng.permutation(mesh.n_edges).astype(np.int64)
    e2v_old = np.asarray(mesh.e2v.table)
    v2e_old = np.asarray(mesh.v2e.table)
    e2v_new = np.empty_like(e2v_old)
    e2v_new[pe] = pv[e2v_old]
    v2e_new = np.empty_like(v2e_old)
    v2e_new[pv] = np.where(v2e_old == -1, -1, pe[np.clip(v2e_old, 0, None)])
    return SimpleMesh(mesh.n_vertices, mesh.n_edges, *_mesh_conns(v2e_new, e2v_new))


def simple_mesh_case(allocator: str = "numpy") -> Tuple[Case, SimpleMesh]:
    mesh = SimpleMesh.make()
    case = Case(
        default_sizes={
            Vertex: mesh.n_vertices,
            Edge: mesh.n_edges,
            V2EDim: mesh.v2e.max_neighbors,
            E2VDim: mesh.e2v.max_neighbors,
            Dimension("K", kind=DimensionKind.VERTICAL): 6,
        },
        offset_provider={"V2E": mesh.v2e, "E2V": mesh.e2v},
        allocator=allocator,
    )
    return case, mesh


def unstructured_fvm_case(n: int = 512, irregular: bool = False, dtype=np.float32,
                          device=None) -> Dict[str, Any]:
    """bench.py's unstructured FVM diffusion step (``bench_tpu_unstructured``:
    edge gradient, signed divergence, ``psi + 0.05 * div``) on
    ``grid_mesh(n)`` or ``shuffled_mesh(n, seed=7)``, with its ``sign``
    field and ``psi0`` (seed 3), on ``device``.  The operators run embedded
    (``with_backend("torch")``; the bridge declines local dimensions, as
    the JAX package's does).  Returns ``mesh``, ``provider``, ``sign``,
    ``psi0`` (a tensor) and ``step(psi) -> psi`` over tensors."""
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dims, FieldOffset, neighbor_sum

    mesh = shuffled_mesh(n, seed=7) if irregular else grid_mesh(n)
    E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
    V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
    T = gtx.float32 if np.dtype(dtype) == np.float32 else gtx.float64

    @gtx.field_operator
    def gradient(psi: Field[Dims[Vertex], T]) -> Field[Dims[Edge], T]:
        return psi(E2V[1]) - psi(E2V[0])

    @gtx.field_operator
    def divergence(flux: Field[Dims[Edge], T],
                   sign: Field[Dims[Vertex, V2EDim], T]) -> Field[Dims[Vertex], T]:
        return neighbor_sum(flux(V2E) * sign, axis=V2EDim)

    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    grad_b = gradient.with_backend("torch")
    div_b = divergence.with_backend("torch")
    t = mesh.v2e.table
    first = mesh.e2v.table[np.clip(t, 0, mesh.n_edges - 1), 0]
    sign_np = np.where(
        t == -1, 0.0, np.where(first == np.arange(mesh.n_vertices)[:, None], 1.0, -1.0)
    ).astype(dtype)
    sign = as_field((Vertex, V2EDim), sign_np, device=device)
    psi0 = torch.from_numpy(
        np.random.default_rng(3).random(mesh.n_vertices).astype(dtype)
    ).to(config.resolve_device(device))

    def step(psi_data):
        psi = gtx.as_field((Vertex,), psi_data)
        g = grad_b(psi, offset_provider=provider)
        d = div_b(g, sign, offset_provider=provider)
        return psi_data + 0.05 * d.data

    return dict(mesh=mesh, provider=provider, sign=sign, psi0=psi0, step=step,
                gradient=grad_b, divergence=div_b)
