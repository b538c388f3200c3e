"""Random stencil-program generator for differential backend testing.

Generates random *valid* GTScript-like programs directly as IR (bypassing
the frontend), runs them on the numpy oracle and the port's executors, and
compares.  This hunts semantic divergence the hand-written suites miss:
random offset patterns, section layouts, mask nesting, temp reuse -- and,
on the ``"cuda"`` backend, the kernel forms the plans choose for them
(tile, row, vector, staged variable-K, fused column, plane-sweep, sweep and
K-blocked kernels; row-phase and element staging; periodic wraps).

``ProgramGenerator`` is a copy of ``gt4py_tpu.testing.program_gen``'s, so
the same seed draws the same program; ``DifferentialCase`` draws the same
domain, arrays and scalars as that module's ``run_differential_case``, and
puts them in one of ``LAYOUTS`` on a device.

The generator respects the parallel-model race rules by construction:
- API output fields are only written at zero offset and never read with
  horizontal offsets;
- in PARALLEL loops, written fields are not read at k offsets;
- temporaries are written before they are read (definitive assignment).
"""

from __future__ import annotations

import copy
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import ir
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import BFLOAT16

MAX_OFFSET = 2


class ProgramGenerator:
    def __init__(
        self,
        rng: random.Random,
        n_inputs: int = 3,
        n_outputs: int = 2,
        dtype=np.float64,
        allow_while: bool = True,
    ):
        self.rng = rng
        #: ``while`` loops compare against thresholds; at 16-bit dtypes a
        #: value within one ulp of the bound can round differently under
        #: the chip's excess-precision arithmetic than under the numpy
        #: oracle, flipping the ITERATION COUNT -- a divergence no
        #: tolerance can cover (chip bf16 fuzz seed 11).  Decision-
        #: boundary-sensitive legs disable whiles.
        self.allow_while = allow_while
        self.inputs = [f"in{i}" for i in range(n_inputs)]
        self.outputs = [f"out{i}" for i in range(n_outputs)]
        self.scalars = ["s0", "s1"]
        self.n_temps = 0
        self.dtype = np.dtype(dtype)

    # ------------------------------------------------------------------ #

    def generate(self) -> ir.Stencil:
        n_loops = self.rng.randint(1, 3)
        loops = []
        self.temps_assigned: List[str] = []
        for _ in range(n_loops):
            loops.append(self._gen_loop())

        field_decls = {
            name: ir.FieldDecl(name=name, dtype=self.dtype)
            for name in self.inputs + self.outputs
        }
        temp_decls = {
            name: ir.FieldDecl(name=name, dtype=self.dtype, is_api=False)
            for name in self.temps_assigned
        }
        params = [
            ir.ApiParam(name=n, is_field=True) for n in self.inputs + self.outputs
        ] + [
            ir.ApiParam(name=n, is_field=False, is_keyword=True)
            for n in self.scalars
        ]
        return ir.Stencil(
            name=f"fuzz_{self.rng.randint(0, 1 << 30)}",
            api_params=params,
            field_decls=field_decls,
            scalar_decls={
                n: ir.ScalarDecl(name=n, dtype=self.dtype) for n in self.scalars
            },
            temp_decls=temp_decls,
            vertical_loops=loops,
            literal_float_dtype=self.dtype,
        )

    # ------------------------------------------------------------------ #

    def _gen_loop(self) -> ir.VerticalLoop:
        order = self.rng.choice(
            [ir.LoopOrder.PARALLEL, ir.LoopOrder.FORWARD, ir.LoopOrder.BACKWARD]
        )
        n_sections = self.rng.randint(1, 2)
        if n_sections == 1:
            intervals = [ir.Interval.full()]
        else:
            split = self.rng.randint(1, 3)
            intervals = [
                ir.Interval(ir.AxisBound.start(), ir.AxisBound.start(split)),
                ir.Interval(ir.AxisBound.start(split), ir.AxisBound.end()),
            ]
            if order == ir.LoopOrder.BACKWARD:
                intervals.reverse()
        sections = []
        for iv in intervals:
            body = self._gen_section_body(order)
            sections.append(ir.VerticalSection(interval=iv, body=body))
        return ir.VerticalLoop(loop_order=order, sections=sections)

    def _gen_section_body(self, order) -> List[ir.Stmt]:
        serial = order != ir.LoopOrder.PARALLEL
        stmts: List[ir.Stmt] = []
        #: names written in this section (serial loops may read them back
        #: at "behind" offsets; PARALLEL only at zero offset)
        written_here: List[str] = []
        for _ in range(self.rng.randint(1, 4)):
            kind = self.rng.random()
            if kind < 0.6 or not written_here:
                stmt = self._gen_assign(order, written_here)
            elif kind < 0.8:
                cond = self._gen_expr(order, written_here, depth=1)
                cond = ir.BinaryOp(
                    op=ir.BinaryOperator.GT, left=cond, right=ir.Literal(value=0.5)
                )
                # conditional writes are NOT definitive: only outputs and
                # already-definitely-assigned temps may be targets, and
                # written_here must not gain new names
                body = [self._gen_assign(order, written_here, conditional=True)]
                orelse = (
                    [self._gen_assign(order, written_here, conditional=True)]
                    if self.rng.random() < 0.5
                    else []
                )
                stmt = ir.If(cond=cond, body=body, orelse=orelse)
            elif kind < 0.9 and self.temps_assigned and self.allow_while:
                # bounded pointwise while: increment a definitely-assigned
                # temp until it clears a nearby bound (terminates in <= ~4
                # iterations since fields start in [0, 1) plus a few ops)
                t = self.rng.choice(self.temps_assigned)
                cond = ir.BinaryOp(
                    op=ir.BinaryOperator.LT,
                    left=ir.FieldAccess(name=t),
                    right=ir.Literal(value=round(self.rng.uniform(0.5, 2.0), 3)),
                )
                body: List[ir.Stmt] = [
                    ir.Assign(
                        target=ir.FieldAccess(name=t),
                        value=ir.BinaryOp(
                            op=ir.BinaryOperator.ADD,
                            left=ir.FieldAccess(name=t),
                            right=ir.Literal(value=1.0),
                        ),
                    )
                ]
                if self.rng.random() < 0.5:
                    extra = self._gen_assign(order, written_here, conditional=True)
                    # the extra assign must not reset the loop counter below
                    # the bound (non-termination)
                    if extra.target.name != t:
                        body.append(extra)
                stmt = ir.While(cond=cond, body=body)
            else:
                # horizontal region: partial write, same rules as masked
                stmt = ir.HorizontalRestriction(
                    masks=[self._gen_hmask() for _ in range(self.rng.randint(1, 2))],
                    body=[self._gen_assign(order, written_here, conditional=True)],
                )
            stmts.append(stmt)
        # ensure at least one output is written somewhere
        if not any(
            isinstance(n, ir.Assign) and n.target.name in self.outputs
            for s in stmts
            for n in ir.walk_values(s)
        ):
            out = self.rng.choice(self.outputs)
            stmts.append(
                ir.Assign(
                    target=ir.FieldAccess(name=out),
                    value=self._gen_expr(order, written_here, depth=0),
                )
            )
        return stmts

    def _gen_hmask(self) -> ir.HorizontalMask:
        def hiv():
            r = self.rng.random()
            if r < 0.3:
                return ir.HorizontalInterval()  # unbounded
            mk = self.rng.choice([ir.AxisBound.start, ir.AxisBound.end])
            o = self.rng.randint(-1, 2)
            lo = mk(o) if mk is ir.AxisBound.start else mk(o - 3)
            hi_mk = self.rng.choice([ir.AxisBound.start, ir.AxisBound.end])
            hi = (
                hi_mk(self.rng.randint(2, 5))
                if hi_mk is ir.AxisBound.start
                else hi_mk(self.rng.randint(-1, 1))
            )
            if r < 0.55:
                return ir.HorizontalInterval(start=lo)
            if r < 0.8:
                return ir.HorizontalInterval(end=hi)
            return ir.HorizontalInterval(start=lo, end=hi)

        return ir.HorizontalMask(i=hiv(), j=hiv())

    def _gen_assign(
        self, order, written_here: List[str], conditional: bool = False
    ) -> ir.Assign:
        r = self.rng.random()
        if conditional:
            # must stay definitively-assigned: outputs or existing temps
            pool = self.outputs + self.temps_assigned
            target = self.rng.choice(pool)
        elif r < 0.4:
            target = self.rng.choice(self.outputs)
        elif r < 0.7 and self.temps_assigned:
            target = self.rng.choice(self.temps_assigned)
        else:
            target = f"tmp{self.n_temps}"
            self.n_temps += 1
        value = self._gen_expr(order, written_here, depth=0)
        if target not in self.temps_assigned and target not in self.outputs:
            # definitively assigned only from this statement on
            self.temps_assigned.append(target)
        # self-reads must be offset-free horizontally (race rule,
        # gtir.py:96-110): neutralize any generated offsets on the target
        for acc in ir.field_accesses(value):
            if acc.name == target and isinstance(acc.offset, ir.CartesianOffset):
                if acc.offset.i or acc.offset.j:
                    acc.offset = ir.CartesianOffset(0, 0, acc.offset.k)
        if not conditional and target not in written_here:
            written_here.append(target)
        return ir.Assign(target=ir.FieldAccess(name=target), value=value)

    def _gen_expr(self, order, written_here: List[str], depth: int) -> ir.Expr:
        serial = order != ir.LoopOrder.PARALLEL
        r = self.rng.random()
        if depth >= 3 or r < 0.35:
            return self._gen_leaf(order, written_here)
        if r < 0.8:
            op = self.rng.choice(
                [
                    ir.BinaryOperator.ADD,
                    ir.BinaryOperator.SUB,
                    ir.BinaryOperator.MUL,
                ]
            )
            return ir.BinaryOp(
                op=op,
                left=self._gen_expr(order, written_here, depth + 1),
                right=self._gen_expr(order, written_here, depth + 1),
            )
        if r < 0.9:
            fn = self.rng.choice(
                [ir.NativeFunction.ABS, ir.NativeFunction.SIN, ir.NativeFunction.TANH]
            )
            return ir.NativeFuncCall(
                func=fn, args=[self._gen_expr(order, written_here, depth + 1)]
            )
        return ir.TernaryOp(
            cond=ir.BinaryOp(
                op=ir.BinaryOperator.LT,
                left=self._gen_leaf(order, written_here),
                right=ir.Literal(value=0.5),
            ),
            true_expr=self._gen_expr(order, written_here, depth + 1),
            false_expr=self._gen_expr(order, written_here, depth + 1),
        )

    def _gen_leaf(self, order, written_here: List[str]) -> ir.Expr:
        serial = order != ir.LoopOrder.PARALLEL
        r = self.rng.random()
        if r < 0.12:
            return ir.Literal(value=round(self.rng.uniform(-2, 2), 3))
        if r < 0.2:
            return ir.ScalarAccess(name=self.rng.choice(self.scalars))
        candidates = list(self.inputs)
        # any definitively-assigned temp is readable: same-section at zero
        # offset (plus behind-the-sweep K in serial loops), earlier-section
        # ones also at horizontal offsets (extent analysis extends them)
        name = self.rng.choice(candidates + self.temps_assigned)
        if name in self.inputs:
            rr = self.rng.random()
            if rr < 0.08:
                # data-dependent K offset (clipped to field bounds)
                return ir.FieldAccess(
                    name=name,
                    offset=ir.VariableKOffset(
                        k=ir.Literal(
                            value=self.rng.randint(-3, 3),
                            dtype=np.dtype(np.int64),
                        )
                    ),
                )
            if rr < 0.16:
                # absolute K read
                return ir.FieldAccess(
                    name=name,
                    offset=ir.AbsoluteKIndex(
                        k=ir.Literal(
                            value=self.rng.randint(0, 4),
                            dtype=np.dtype(np.int64),
                        )
                    ),
                )
            di = self.rng.randint(-MAX_OFFSET, MAX_OFFSET)
            dj = self.rng.randint(-MAX_OFFSET, MAX_OFFSET)
            dk = self.rng.randint(-1, 1)
            return ir.FieldAccess(name=name, offset=ir.CartesianOffset(di, dj, dk))
        if name in written_here and serial and self.rng.random() < 0.4:
            behind = -1 if order == ir.LoopOrder.FORWARD else 1
            return ir.FieldAccess(
                name=name, offset=ir.CartesianOffset(0, 0, behind)
            )
        if name not in written_here and self.rng.random() < 0.5:
            # temp from an earlier section: horizontal offsets are legal
            di = self.rng.randint(-1, 1)
            dj = self.rng.randint(-1, 1)
            return ir.FieldAccess(name=name, offset=ir.CartesianOffset(di, dj, 0))
        return ir.FieldAccess(name=name)



#: the buffer layouts ``run_differential_case`` puts each field in
LAYOUTS = ("ijk", "kij_aligned", "kij_tight")

#: the card's fuzz legs (``chip_smoke.py --fuzz``, ``tests/test_torch_cuda.py``):
#: name -> (seeds, ``run_differential_case`` keywords); the f32 and bf16
#: legs' tolerances are the oracle's (kernel against plain: the caller's).
#: The serialized leg builds with ``sweep=True`` where the sweep plans,
#: else ``serialize=True`` (``declined_builds`` says why); a program that
#: declines both declines
SERIALIZED_BUILDS = ({"serialize": True, "sweep": True}, {"serialize": True})
LEGS = {
    "base": (range(40), dict(layout="ijk")),
    "kij_aligned": (range(24), dict(layout="kij_aligned")),
    "kij_tight": (range(24), dict(layout="kij_tight")),
    "periodic": (range(24), dict(layout="kij_aligned", periodic=("I", "J"))),
    "wide": (range(8), dict(layout="kij_tight", domain=(37, 70, 23))),
    "deep": (range(4), dict(layout="kij_aligned", domain=(8, 8, 600))),
    "serialized": (range(8), dict(layout="kij_aligned", options=SERIALIZED_BUILDS)),
    "f32": (range(12), dict(layout="kij_aligned", dtype=np.float32, rtol=3e-5, atol=3e-6)),
    "bf16": (range(4), dict(layout="kij_aligned", dtype=BFLOAT16, canonical_f16=True,
                            allow_while=False, rtol=2e-2, atol=1e-2)),
}
#: the programs of ``LEGS`` the ``"cuda"`` backend has no kernel form for
#: (ROADMAP Queue 3, open): (leg, seed) -> the reason its build names.
#: Each must decline, and no other program may
LEG_DECLINES: Dict[Tuple[str, int], str] = {}


def _buffer(a: np.ndarray, dtype, layout: str, device) -> torch.Tensor:
    """The logical (I, J, K) array ``a`` as an (I, J, K) tensor view, in
    ``dtype`` on ``device``, of a buffer in ``layout``:

    - ``"ijk"``: C order, K contiguous (the JAX fuzzer's arrays);
    - ``"kij_aligned"``: a (K, I, J) buffer, J contiguous, its rows padded
      to whole 16-byte words (16-byte row and level pitches), as the
      models allocate;
    - ``"kij_tight"``: a (K, I, J) buffer whose row pitch is an odd number
      of elements, so consecutive rows start at different 16-byte phases.

    Padding elements hold NaN (floats), so a kernel that reads them
    shows."""
    t = dtypes.cast(torch.from_numpy(np.ascontiguousarray(a)), dtype).to(device)
    if layout == "ijk":
        return t
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (one of {LAYOUTS})")
    SI, SJ, SK = a.shape
    if layout == "kij_aligned":
        m = 16 // t.element_size()
        pitch = -(-SJ // m) * m
    else:
        pitch = SJ if SJ % 2 else SJ + 1
    buf = torch.full((SK, SI, pitch), float("nan"), dtype=t.dtype, device=device) \
        if t.dtype.is_floating_point else torch.zeros((SK, SI, pitch), dtype=t.dtype,
                                                      device=device)
    buf[:, :, :SJ] = t.permute(2, 0, 1)
    return buf.permute(1, 2, 0)[:, :SJ, :]


def _logical(t: torch.Tensor) -> np.ndarray:
    """A field tensor's values as a float64 (or integer) numpy array."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16, torch.float32):
        t = t.to(torch.float64)
    return t.numpy().copy()


def _generate(seed: int, domain, dtype, allow_while: bool):
    """The JAX fuzzer's draws: ``random.Random(seed)`` gives the domain
    (when none is given: I, J in [3, 9], K in [1, 7]) then the program."""
    rng = random.Random(seed)
    if domain is None:
        domain = (rng.randint(3, 9), rng.randint(3, 9), rng.randint(1, 7))
    gen = ProgramGenerator(rng, dtype=dtype, allow_while=allow_while)
    return gen, gen.generate(), tuple(int(d) for d in domain)


class DifferentialCase:
    """One generated program and its inputs, runnable on each backend.

    The same ``seed`` draws the same program, domain, arrays and scalars as
    ``gt4py_tpu.testing.program_gen.run_differential_case`` (non-aligned
    geometry), so results can be held against the JAX package's oracle.
    ``inputs`` are the logical (I, J, K) arrays (origin ``(halo, halo,
    1)``), ``scalars`` the scalar arguments.  ``options``: the ``"cuda"``
    build options, or a sequence of them tried in order: the first whose
    plan builds is used, and each one that declines (a forced form that
    cannot apply names why) is kept in ``declined_builds``.

    bfloat16: numpy has no such dtype here, so the oracle runs the same
    seed's program generated in float32 on the inputs rounded to bfloat16
    (with ``canonical_f16`` the bfloat16 program computes in float32 too).
    """

    def __init__(self, seed: int, domain=None, halo: int = 6, dtype=np.float64,
                 layout: str = "ijk", periodic=(), canonical_f16: bool = False,
                 allow_while: bool = True, options=None):
        from gt4py_tpu_torch.cartesian import analysis as analysis_mod
        from gt4py_tpu_torch.cartesian import passes as passes_mod

        self.seed = seed
        self.dtype = np.dtype(dtype)
        self.layout = layout
        self.periodic = tuple(periodic)
        #: the domain was drawn from the seed (the JAX fuzzer's draws), not given
        self.drew_domain = domain is None
        self.gen, stencil, self.domain = _generate(seed, domain, dtype, allow_while)
        if canonical_f16:
            stencil = passes_mod.widen_f16_compute(stencil)
        self.stencil = stencil
        self.analysis = analysis_mod.analyze(stencil)
        if self.dtype == BFLOAT16:
            _, oracle, _ = _generate(seed, domain, np.float32, allow_while)
            self.oracle_analysis = analysis_mod.analyze(oracle)
        else:
            self.oracle_analysis = self.analysis
        nprng = np.random.default_rng(seed)
        dI, dJ, dK = self.domain
        shape = (dI + 2 * halo, dJ + 2 * halo, dK + 2)
        self.origin = (halo, halo, 1)
        self.inputs: Dict[str, np.ndarray] = {}
        for name in self.gen.inputs + self.gen.outputs:
            # the field dtype's values, in float64 (bfloat16 rounded as the
            # JAX package's ml_dtypes rounds)
            self.inputs[name] = _logical(dtypes.cast(torch.from_numpy(nprng.random(shape)),
                                                     self.dtype))
        self.scalars = {"s0": nprng.uniform(-1, 1), "s1": nprng.uniform(-1, 1)}
        opts = options if isinstance(options, (list, tuple)) else [options or {}]
        self.option_choices = [dict(o) for o in opts]
        self.options: Optional[dict] = None
        self.declined_builds: List[Tuple[dict, str]] = []
        self._backends: Dict[str, object] = {}

    @property
    def names(self) -> List[str]:
        """The fields compared: written ones only under ``periodic`` (the
        oracle's fill writes the read-only inputs' halos in place)."""
        return self.gen.outputs if self.periodic else self.gen.outputs + self.gen.inputs

    def backend(self, name: str):
        """The backend object ``name`` runs (built once; ``"cuda"`` with
        the first of ``options`` that plans)."""
        from gt4py_tpu_torch.cartesian.backend import from_name

        if name not in self._backends:
            if name == "cuda":
                from gt4py_tpu_torch.cartesian.backend.cuda_backend import _Decline

                if self.declined_builds and len(self.declined_builds) == len(
                        self.option_choices):
                    raise NotImplementedError(
                        f"seed {self.seed}: no build options planned: {self.declined_builds}")
                for opts in self.option_choices:
                    try:
                        self._backends[name] = from_name(name)(self.analysis, opts)
                    except _Decline as e:
                        self.declined_builds.append((opts, str(e)))
                        continue
                    self.options = opts
                    break
                else:
                    raise NotImplementedError(
                        f"seed {self.seed}: no build options planned: {self.declined_builds}")
            else:
                an = self.oracle_analysis if name in ("numpy", "debug") else self.analysis
                self._backends[name] = from_name(name)(an, {})
        return self._backends[name]

    def run(self, name: str, device="cpu") -> Dict[str, np.ndarray]:
        """Call the program on backend ``name`` through a ``StencilObject``
        (no argument validation, as the JAX fuzzer calls its backends),
        on fresh copies of the inputs (``numpy`` and ``debug``: on the
        host, in the oracle's dtype; the others: in ``layout`` on
        ``device``); the logical arrays after the call."""
        from gt4py_tpu_torch.cartesian.stencil_object import StencilObject

        backend = self.backend(name)
        an = backend.analysis if name != "cuda" else self.analysis
        host = name in ("numpy", "debug")
        dtype = an.stencil.field_decls[self.gen.inputs[0]].dtype
        tensors = {n: (torch.from_numpy(a.astype(dtype)) if host else
                       _buffer(a, dtype, self.layout, device))
                   for n, a in self.inputs.items()}
        obj = StencilObject(analysis=an, backend=backend, backend_name=name,
                            name=an.stencil.name, options=self.options or {},
                            stencil_id=f"fuzz-{self.seed}-{name}")
        obj(**tensors, **self.scalars, origin=self.origin, domain=self.domain,
            validate_args=False, periodic=self.periodic)
        return {n: _logical(t) for n, t in tensors.items()}


def run_differential_case(seed: int, domain=None, halo: int = 6, backends=("torch",),
                          dtype=np.float64, layout: str = "ijk", rtol=1e-12, atol=1e-12,
                          periodic=(), canonical_f16: bool = False, allow_while: bool = True,
                          max_flip_fraction: float = 0.0, device="cpu", options=None,
                          kernel_rtol=None, kernel_atol=None, count_kernels=None,
                          allow_declines: bool = False,
                          case: Optional[DifferentialCase] = None) -> DifferentialCase:
    """Generate one program (``DifferentialCase``), run the port's numpy
    oracle and each backend of ``backends`` (``"torch"``, ``"cuda"``,
    ``"debug"``) on ``device``, and assert allclose.  Returns the case with
    ``results`` (backend -> field -> logical array; ``"numpy"`` the
    oracle's), ``rejected`` (the oracle raised ``ValueError`` for a read
    halo wider than a periodic domain, and so did every backend),
    ``launches`` (the kernels the ``"cuda"`` leg launched, counted by its
    library), ``launch_counts`` (the library's counts by kernel,
    ``CudaBackend.device_launches``), ``forms`` (those launches by kernel
    form, ``CudaBackend.launches_by_form``; they add up to ``launches``)
    and ``plan`` (its call's ``cuda_backend.LAST_PLAN`` record).

    ``max_flip_fraction``: for programs with data-dependent branches, the
    share of points that may differ from the ORACLE beyond tolerance (a
    condition within an ulp of its threshold flips under another
    rounding); the ``"cuda"`` leg against the ``"torch"`` leg is held at
    ``kernel_rtol``/``kernel_atol`` (default ``rtol``/``atol``) with no
    allowance.  ``count_kernels`` (default: on CUDA devices): build the
    ``"cuda"`` leg's library first and require that the call launched at
    least one kernel.  ``allow_declines``: where the ``"cuda"`` backend
    declines to build the program (``NotImplementedError`` naming a form it
    has no kernel for, raised before anything runs), record the reason in
    ``declined`` and run the other legs; otherwise it propagates.
    ``case``: a prepared case (its builds done)."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    case = case or DifferentialCase(seed, domain=domain, halo=halo, dtype=dtype, layout=layout,
                                    periodic=periodic, canonical_f16=canonical_f16,
                                    allow_while=allow_while, options=options)
    device = torch.device(device)
    if count_kernels is None:
        count_kernels = device.type == "cuda"
    case.results, case.rejected, case.launches, case.plan = {}, False, 0, None
    case.launch_counts, case.forms = None, {}
    case.declined = None
    if "cuda" in backends:
        try:
            case.backend("cuda")
        except NotImplementedError as e:
            if not allow_declines:
                raise
            case.declined = str(e)
            backends = tuple(b for b in backends if b != "cuda")
    try:
        case.results["numpy"] = case.run("numpy")
    except ValueError:
        # read halo wider than the periodic domain: the oracle rejects;
        # every backend must reject identically (no silent multi-wrap)
        for backend in backends:
            try:
                case.run(backend, device)
            except ValueError:
                continue
            raise AssertionError(
                f"seed {seed}: oracle rejects periodic domain but "
                f"'{backend}' accepted it\n" + _dump(case.stencil)
            )
        case.rejected = True
        return case

    ref = case.results["numpy"]
    flips_ok = max_flip_fraction > 0 and _has_data_branches(case.stencil)
    for backend in backends:
        if backend == "cuda" and count_kernels:
            be = case.backend("cuda")
            be.build()
            before = be.device_launches()
        case.results[backend] = got = case.run(backend, device)
        if backend == "cuda":
            case.plan = copy.deepcopy(cuda_backend.LAST_PLAN.get(case.stencil.name))
            if count_kernels:
                after = be.device_launches()
                case.launch_counts = {
                    k: [a - b for a, b in zip(v, before[k])] if isinstance(v, list)
                    else v - before[k] for k, v in after.items()}
                case.launches = case.launch_counts["all"]
                case.forms = be.launches_by_form(case.launch_counts)
                if case.launches < 1:
                    raise AssertionError(f"seed {seed}: the 'cuda' leg launched no kernel "
                                         f"on {device}\n" + _dump(case.stencil))
                if sum(case.forms.values()) != case.launches:
                    raise AssertionError(f"seed {seed}: launches by form {case.forms} do not "
                                         f"add up to the library's {case.launches}")
        for name in case.names:
            if flips_ok and _flip_fraction(got[name], ref[name], rtol, atol) <= max_flip_fraction:
                # REAL-CHIP comparison contract: a data-dependent branch
                # condition within one ulp of its threshold can FLIP vs the
                # oracle -- an isolated point then takes a different branch
                # (or while-iteration count) and no tolerance covers the
                # delta.  Allow a TINY fraction of such points for programs
                # that actually contain data-dependent branches.
                continue
            np.testing.assert_allclose(
                got[name], ref[name], rtol=rtol, atol=atol,
                err_msg=f"seed {seed}: field '{name}' diverges ({backend} vs the numpy "
                        f"oracle, {case.layout} on {device})\n" + _dump(case.stencil))
    if "cuda" in backends and "torch" in backends:
        for name in case.names:
            np.testing.assert_allclose(
                case.results["cuda"][name], case.results["torch"][name],
                rtol=rtol if kernel_rtol is None else kernel_rtol,
                atol=atol if kernel_atol is None else kernel_atol,
                err_msg=f"seed {seed}: field '{name}': the kernels diverge from the plain "
                        f"executor ({case.layout} on {device}, options {case.options})\n"
                        + _dump(case.stencil))
    return case


def _flip_fraction(got, ref, rtol, atol) -> float:
    """The share of points beyond tolerance (NaN equal to NaN)."""
    with np.errstate(invalid="ignore"):
        bad = ~np.isclose(got, ref, rtol=rtol, atol=atol, equal_nan=True)
    return float(bad.sum() / bad.size)


def _has_data_branches(stencil) -> bool:
    """Does any If/While/ternary condition read a field or temp?  Only
    such programs can exhibit on-chip branch flips (scalar/literal
    conditions evaluate identically everywhere)."""

    def cond_reads_field(cond) -> bool:
        if isinstance(cond, ir.FieldAccess):
            return True
        return any(
            cond_reads_field(c)
            for c in ir.children(cond)
            if not isinstance(c, (str, int, float, bool, type(None)))
        )

    for node in ir.walk_values(stencil.vertical_loops):
        if isinstance(node, (ir.If, ir.While, ir.TernaryOp)):
            if cond_reads_field(node.cond):
                return True
    return False


def _dump(stencil) -> str:
    from gt4py_tpu_torch.cartesian.pretty import pformat_stencil

    return pformat_stencil(stencil)
