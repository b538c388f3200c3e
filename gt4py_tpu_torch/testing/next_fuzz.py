"""Random field-operator generator for differential next-DSL testing.

Counterpart of ``gt4py_tpu.testing.next_fuzz`` for the port: generates
random *valid* operator source in the restricted-Python subset, parses it
through the real frontend (type deduction + validation), and runs it on
the numpy oracle (numpy-backed Fields), embedded on torch tensors of a
device, and on the ``"cuda"`` backend (``next/cuda_bridge.py``: eligible
operators, scans and program segments lowered onto the cartesian kernels,
the rest embedded, each such fallback recorded in ``FALLBACK_EVENTS``).

``OperatorGenerator`` and ``_scan_expr`` are copies of the JAX module's, so
the same seed draws the same source text.  The case builders
(``operator_case``, ``program_case``, ``bridge_case``) take the package
that defines the DSL (``gt4py_tpu_torch.next``, or any package with its
API) and keyword arguments for its ``as_field``/``as_connectivity``, so a
test can build the very same case on the JAX package and hold the port's
results to that package's oracle.  The runners (``run_differential_case``,
``run_program_case``, ``run_bridge_case``) run the port's backends and
return a ``NextCase``: the source, each leg's results, how many of the
``"cuda"`` leg's operators ran embedded (counted, not required to be zero,
as the JAX fuzzer's pallas leg falls back too) and the kernels it launched.
"""

from __future__ import annotations

import linecache
import random
import textwrap
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np


class OperatorGenerator:
    """Builds one random field-operator source string + its closure."""

    def __init__(self, rng: random.Random, with_unstructured: bool = False,
                 with_collection: bool = False, with_provider: bool = False):
        self.rng = rng
        self.with_unstructured = with_unstructured
        self.with_collection = with_collection
        # provider leg: V2E is a named FieldOffset resolved through the
        # call-time offset_provider instead of a closure Connectivity
        self.with_provider = with_provider
        self.lines: List[str] = []
        self.n_tmp = 0

    def _leaf(self, names: List[str]) -> str:
        r = self.rng.random()
        if r < 0.55:
            name = self.rng.choice(names)
            # only certainly-field names may be shifted (the type system
            # rejects calling a scalar-typed temp -- correctly)
            if (
                not self.with_unstructured
                and name in self.field_names
                and self.rng.random() < 0.35
            ):
                off = self.rng.choice(["Ioff", "Joff"])
                k = self.rng.randint(-2, 2)
                return f"{name}({off}[{k}])"
            return name
        if r < 0.75:
            return "s"
        return repr(round(self.rng.uniform(-1.5, 1.5), 3))

    def _expr(self, names: List[str], depth: int = 0) -> str:
        r = self.rng.random()
        if depth >= 3 or r < 0.3:
            return self._leaf(names)
        if r < 0.7:
            op = self.rng.choice(["+", "-", "*"])
            return f"({self._expr(names, depth + 1)} {op} {self._expr(names, depth + 1)})"
        if r < 0.85:
            c = self._expr(names, depth + 1)
            t = self._expr(names, depth + 1)
            f = self._expr(names, depth + 1)
            return f"where(({c}) > 0.25, {t}, {f})"
        fn = self.rng.choice(["minimum", "maximum"])
        return f"{fn}({self._expr(names, depth + 1)}, {self._expr(names, depth + 1)})"

    def _is_field_expr(self, expr: str) -> bool:
        import re

        return any(re.search(rf"\b{n}\b", expr) for n in self.field_names)

    def generate(self) -> str:
        self.field_names = {"a", "b"}
        names = ["a", "b"]
        body = []
        if self.with_collection:
            # params arrive as a named collection: member access + (maybe)
            # an in-operator constructor round-trip
            body += ["a = pair.a", "b = pair.b"]
        for _ in range(self.rng.randint(1, 3)):
            t = f"t{self.n_tmp}"
            self.n_tmp += 1
            if not self.with_unstructured and self.rng.random() < 0.2:
                # boundary-condition pattern: concat_where along J
                c = self.rng.randint(2, 7)
                rel = self.rng.choice(["<", ">=", "<=", ">"])
                ea = f"({self._expr(names)}) + 0.0 * a"
                eb = f"({self._expr(names)}) + 0.0 * b"
                body.append(f"{t} = concat_where(J {rel} {c}, {ea}, {eb})")
                self.field_names.add(t)
                names.append(t)
                continue
            e = self._expr(names)
            body.append(f"{t} = {e}")
            if self._is_field_expr(e):
                self.field_names.add(t)
            names.append(t)
        if self.with_collection and self.rng.random() < 0.6:
            # both member exprs anchored to the field dtype: the ctor
            # type-checks members against the declared (field) types
            ea = f"({self._expr(names)}) + 0.0 * a"
            eb = f"({self._expr(names)}) + 0.0 * b"
            body.append(f"col = PT(a={ea}, b={eb})")
            body.append("ca = col.a")
            self.field_names.add("ca")
            names.append("ca")
        if self.with_unstructured:
            e = self._expr(names)
            if not self._is_field_expr(e):
                e = f"({e}) + 0.0 * a"
            if self.with_provider and self.rng.random() < 0.4:
                # neighbor selection through the provider table
                body.append(f"r = ({e})(V2E[{self.rng.randint(0, 2)}])")
            elif self.with_provider:
                # skip mask resolved from the ambient provider
                body.append(f"r = neighbor_sum(({e})(V2E), axis=V2EDim)")
            else:
                body.append(f"r = neighbor_sum(({e})(V2E), axis=V2E)")
            ret = "r"
        else:
            ret = self._expr(names)
            if not self._is_field_expr(ret):
                ret = f"({ret}) + 0.0 * a"
        sig = (
            "def op(pair: PT, s: float64) -> RT:"
            if self.with_collection
            else "def op(a: FT, b: FT, s: float64) -> RT:"
        )
        src = sig + "\n" + textwrap.indent(
            "\n".join(body + [f"return {ret}"]), "    "
        )
        return src


def _register(src: str, filename: str):
    """Compile ``src`` under ``filename`` (the frontend reads the source
    back through linecache)."""
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    return compile(src, filename, "exec")


@dataclass
class NextCase:
    """One generated next-DSL case on the port: its source, each leg's
    result (``label`` -> numpy array, tuple of them, or an exception's
    type name), and the ``"cuda"`` leg's fallbacks (operators that ran
    embedded), kernel launches (counted by the stencil libraries) and
    whether it lowered to kernel plans."""

    seed: int
    src: str
    results: Dict[str, Any] = field(default_factory=dict)
    fallbacks: int = 0
    launches: int = 0
    lowered: bool = False
    #: the ``"cuda"`` leg's kernel wrappers (``CudaBackend``s)
    kernels: List[Any] = field(default_factory=list)


def _result(out):
    """A call's result as (values, dims, domain ranges) per member."""
    outs = out if isinstance(out, tuple) else (out,)
    return tuple((np.asarray(o.asnumpy()), tuple(o.dims), tuple(o.domain.ranges))
                 for o in outs)


def _assert_same(seed, label, ref, got, rtol, atol, src):
    if isinstance(ref, str) or isinstance(got, str):
        assert ref == got, (f"seed {seed}: {label} error-path diverges "
                            f"(oracle: {ref!r}, {label}: {got!r})\n{src}")
        return
    assert len(ref) == len(got), f"seed {seed}: {label}: arity diverges\n{src}"
    for j, (r, g) in enumerate(zip(ref, got)):
        if isinstance(r, tuple):
            (rv, rd, rdom), (gv, gd, gdom) = r, g
            assert rd == gd, f"seed {seed}: {label} out {j} dims diverge {rd} vs {gd}\n{src}"
            assert rdom == gdom, (f"seed {seed}: {label} out {j} domains diverge "
                                  f"{rdom} vs {gdom}\n{src}")
        else:
            rv, gv = r, g
        np.testing.assert_allclose(
            np.asarray(gv, dtype=np.float64), np.asarray(rv, dtype=np.float64), rtol=rtol,
            atol=atol, err_msg=f"seed {seed}: {label} out {j} diverges from the oracle\n{src}")


class _CudaCount:
    """From its creation to ``done(bound, case)``: the fallbacks
    ``cuda_bridge`` recorded, the kernel launches the stencil libraries
    made (``cuda_backend.library_launches``), and the kernel wrappers of
    ``bound`` (a ``"cuda"``-bound operator or program)."""

    def __init__(self):
        from gt4py_tpu_torch.cartesian.backend import cuda_backend
        from gt4py_tpu_torch.next import cuda_bridge

        self.cursor = cuda_bridge.FALLBACK_EVENTS.cursor()
        self.launched = cuda_backend.library_launches()

    def done(self, bound, case: "NextCase") -> None:
        """Record them in ``case``."""
        from gt4py_tpu_torch.cartesian.backend import cuda_backend
        from gt4py_tpu_torch.next import cuda_bridge

        case.fallbacks = len(cuda_bridge.FALLBACK_EVENTS.since(self.cursor))
        case.kernels = cuda_bridge.kernels_of(bound)
        case.launches = cuda_backend.library_launches() - self.launched


def operator_case(seed: int, gtx, dtype=np.float64, conn_kw=None) -> SimpleNamespace:
    """The JAX fuzzer's ``run_differential_case`` draws for ``seed`` on the
    package ``gtx``: the operator, its numpy inputs and scalar, and
    ``call(op, a, b, s)``.  ``conn_kw``: ``as_connectivity`` keywords."""
    rng = random.Random(seed)
    unstructured = rng.random() < 0.3
    provider = unstructured and rng.random() < 0.5
    collection = not unstructured and rng.random() < 0.35

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    Vertex = gtx.Dimension("Vertex")
    Edge = gtx.Dimension("Edge")
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))

    nprng = np.random.default_rng(seed)
    offset_provider = None
    V2EDim = None
    if unstructured:
        nv, ne, width = 6, 9, 3
        table = np.full((nv, width), -1, dtype=np.int64)
        for v in range(nv):
            n = nprng.integers(1, width + 1)
            table[v, :n] = nprng.integers(0, ne, n)
        conn = gtx.as_connectivity(table, source=Vertex, codomain=Edge, **(conn_kw or {}))
        V2EDim = conn.local_dim
        if provider:
            V2E = gtx.FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
            offset_provider = {"V2E": conn}
        else:
            V2E = conn
        FT = gtx.Field[gtx.Dims[Edge], dtype]
        RT = gtx.Field[gtx.Dims[Vertex], dtype]
        data_dims, shape = (Edge,), (ne,)
    else:
        V2E = None
        FT = gtx.Field[gtx.Dims[I, J], dtype]
        RT = gtx.Field[gtx.Dims[I, J], dtype]
        data_dims, shape = (I, J), (10, 9)

    gen = OperatorGenerator(rng, with_unstructured=unstructured, with_collection=collection,
                            with_provider=provider)
    src = gen.generate()

    from typing import NamedTuple as _NamedTuple

    PT = _NamedTuple("PT", [("a", FT), ("b", FT)])
    ns = dict(
        FT=FT, RT=RT, PT=PT, float64=dtype, where=gtx.where, minimum=gtx.minimum,
        maximum=gtx.maximum, neighbor_sum=gtx.neighbor_sum, Ioff=Ioff, Joff=Joff,
        V2E=V2E, V2EDim=V2EDim, concat_where=gtx.concat_where, I=I, J=J,
    )
    exec(_register(src, f"<next-fuzz-{seed}>"), ns)
    op = gtx.field_operator(ns["op"])

    a_np = nprng.random(shape).astype(dtype)
    b_np = nprng.random(shape).astype(dtype)
    s = np.dtype(dtype).type(nprng.uniform(-1, 1))
    by_kw = collection and rng.random() < 0.5

    def call(fn, a, b, z):
        if collection:
            return fn(pair=PT(a=a, b=b), s=z) if by_kw else fn(PT(a=a, b=b), z)
        return fn(a, b, z, offset_provider=offset_provider)

    return SimpleNamespace(src=src, op=op, a=a_np, b=b_np, s=s, dims=data_dims, call=call,
                           collection=collection)


def _field_kw(device):
    return {"allocator": "numpy"} if device == "numpy" else {"device": device}


def run_differential_case(seed: int, rtol=1e-12, atol=1e-12, transforms: bool = False,
                          dtype=np.float64, device="cpu") -> NextCase:
    """One random operator on the numpy oracle (numpy Fields), embedded on
    ``device`` (torch) and on ``"cuda"``; dims, domains and values must
    agree (or every leg reject the call with the same error).
    ``transforms``: the ``"cuda"`` leg must also agree with the embedded
    one at each of three scalar values (the JAX fuzzer's jit/vmap
    invariance, here between the embedded run and the kernels)."""
    import gt4py_tpu_torch.next as gtx

    case = None
    results = {}
    for label, where in (("numpy_oracle", "numpy"), ("torch", device), ("cuda", device)):
        c = operator_case(seed, gtx, dtype, conn_kw=_field_kw(where))
        case = case or NextCase(seed, c.src)
        a = gtx.as_field(c.dims, c.a.copy(), **_field_kw(where))
        b = gtx.as_field(c.dims, c.b.copy(), **_field_kw(where))
        fn = c.op.with_backend("cuda") if label == "cuda" else c.op
        count = _CudaCount()
        try:
            out = _result(c.call(fn, a, b, c.s))
        except ValueError as e:
            # a generated case can be legitimately rejected at runtime
            # (e.g. concat_where pieces left a gap after branch shifts);
            # every path must then reject identically
            out = type(e).__name__
        if label == "cuda":
            count.done(fn, case)
        results[label] = out
    case.results = results
    for label in ("torch", "cuda"):
        _assert_same(seed, label, results["numpy_oracle"], results[label], rtol, atol, case.src)
    if transforms and not isinstance(results["torch"], str):
        for sv in np.linspace(-1.0, 1.0, 3):
            z = np.dtype(dtype).type(sv)
            a = gtx.as_field(c.dims, c.a.copy(), device=device)
            b = gtx.as_field(c.dims, c.b.copy(), device=device)
            eager = _result(c.call(c.op, a, b, z))
            kern = _result(c.call(c.op.with_backend("cuda"), a, b, z))
            _assert_same(seed, f"cuda at s={sv}", eager, kern, rtol, atol, case.src)
    return case


def program_case(seed: int, gtx, field_kw) -> SimpleNamespace:
    """The JAX fuzzer's ``run_program_case`` draws for ``seed`` on the
    package ``gtx``: the program and ``run(backend, field_kw)`` -> its out
    buffers (numpy) or an error's type name."""
    rng = random.Random(seed ^ 0x5EED)
    nprng = np.random.default_rng(seed ^ 0x5EED)

    I = gtx.Dimension("I")
    # J doubles as the scan axis for generated scan statements
    J = gtx.Dimension("J", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    ni, nj = 10, 9
    FT = gtx.Field[gtx.Dims[I, J], np.float64]

    ns = dict(
        FT=FT, RT=FT, float64=np.float64, where=gtx.where, minimum=gtx.minimum,
        maximum=gtx.maximum, Ioff=Ioff, Joff=Joff, concat_where=gtx.concat_where, I=I, J=J,
    )

    ops = []
    srcs = []
    for k in range(rng.randint(1, 2)):
        gen = OperatorGenerator(rng)
        src = gen.generate().replace("def op(", f"def op{k}(")
        srcs.append(src)
        exec(_register(src, f"<next-fuzz-prog-{seed}-op{k}>"), ns)
        ops.append(gtx.field_operator(ns[f"op{k}"]))

    scan_stmt = rng.random() < 0.35
    if scan_stmt:
        ssrc = (
            "def sc(c: float64, x: float64, w: float64) -> float64:\n"
            f"    return c * {round(rng.uniform(0.3, 0.9), 3)} + x * w\n"
        )
        sns = dict(ns)
        exec(_register(ssrc, f"<next-fuzz-prog-{seed}-scan>"), sns)
        scanf = gtx.scan_operator(
            axis=J, forward=bool(rng.random() < 0.5), init=np.float64(0.0)
        )(sns["sc"])

    tuple_stmt = rng.random() < 0.4
    if tuple_stmt:
        tsrc = (
            "def optup(a: FT, b: FT, s: float64) -> TT:\n"
            f"    return opf0(a, b, s), opf{len(ops) - 1}(b, a, s)\n"
        )
        tns = dict(ns)
        tns["TT"] = tuple[FT, FT]
        for k, op in enumerate(ops):
            tns[f"opf{k}"] = op
        exec(_register(tsrc, f"<next-fuzz-prog-{seed}-optup>"), tns)
        optup = gtx.field_operator(tns["optup"])

    n_out = rng.randint(1, 2) + (2 if tuple_stmt else 0) + (1 if scan_stmt else 0)
    n_plain = n_out - (2 if tuple_stmt else 0) - (1 if scan_stmt else 0)
    body = []
    for j in range(n_plain):
        k = rng.randrange(len(ops))
        target = f"o{j}"
        form = rng.random()
        kw = ""
        if form < 0.5:
            lo = 2
            hi = rng.choice([-2, -3])
            target = f"o{j}[{lo}:{hi}, 2:-2]"
        else:
            kw = ", domain={I: (2, 7), J: (2, 7)}"
        body.append(f"    opf{k}(a, b, s, out={target}{kw})")
    if scan_stmt:
        js = n_plain
        target = f"o{js}" if rng.random() < 0.5 else f"o{js}[2:-2, 2:-2]"
        body.append(f"    scanf(a, s, out={target})")
    if tuple_stmt:
        j0, j1 = n_out - 2, n_out - 1
        if rng.random() < 0.5:
            target = f"(o{j0}[2:-2, 2:-2], o{j1}[2:-2, 2:-2])"
            kw = ""
        else:
            target = f"(o{j0}, o{j1})"
            kw = ", domain={I: (2, 7), J: (2, 7)}"
        body.append(f"    optupf(a, b, s, out={target}{kw})")
    params = ", ".join(
        ["a: FT", "b: FT", "s: float64"] + [f"o{j}: FT" for j in range(n_out)]
    )
    psrc = f"def prog({params}):\n" + "\n".join(body)
    pns = dict(ns)
    for k, op in enumerate(ops):
        pns[f"opf{k}"] = op
    if tuple_stmt:
        pns["optupf"] = optup
    if scan_stmt:
        pns["scanf"] = scanf
    exec(_register(psrc, f"<next-fuzz-prog-{seed}>"), pns)
    prog = gtx.program(pns["prog"])

    a_np = nprng.random((ni, nj))
    b_np = nprng.random((ni, nj))
    s = float(nprng.uniform(-1, 1))

    from importlib import import_module

    FieldViewError = import_module(gtx.__name__ + ".frontend").FieldViewError

    def run(backend, kw):
        a = gtx.as_field((I, J), a_np.copy(), **kw)
        b = gtx.as_field((I, J), b_np.copy(), **kw)
        outs = [gtx.as_field((I, J), np.full((ni, nj), -3.0), **kw) for _ in range(n_out)]
        p = prog if backend is None else prog.with_backend(backend)
        try:
            p(a, b, s, *outs)
        except (FieldViewError, ValueError) as e:
            # deeply chained shifts can make a generated write legitimately
            # uncoverable; EVERY path must then reject it the same way
            return type(e).__name__, p
        return [np.asarray(o.asnumpy()) for o in outs], p

    return SimpleNamespace(src=psrc + "\n" + "\n".join(srcs), run=run)


def run_program_case(seed: int, rtol=1e-12, atol=1e-12, device="cpu") -> NextCase:
    """Random multi-statement PROGRAMS (operator calls with out= targets:
    plain names, relative slices, tuples; domain= dict literals; scan
    statements) on the numpy oracle, embedded on ``device``, on
    ``"torch"`` and on ``"cuda"`` (fused segments where eligible): the
    out buffers must be identical, the untouched fill of unwritten halo
    regions included."""
    import gt4py_tpu_torch.next as gtx

    c = program_case(seed, gtx, None)
    case = NextCase(seed, c.src)
    case.results["numpy_oracle"] = c.run("numpy_oracle", {"allocator": "numpy"})[0]
    for label, backend in (("embedded", None), ("torch", "torch"), ("cuda", "cuda")):
        count = _CudaCount()
        got, bound = c.run(backend, {"device": device})
        if label == "cuda":
            count.done(bound, case)
            case.lowered = bool(case.kernels)
        case.results[label] = got
        _assert_same(seed, label, case.results["numpy_oracle"], got, rtol, atol, case.src)
    return case


# --------------------------------------------------------------------- #
# cuda-bridge differential leg
# --------------------------------------------------------------------- #


def _scan_expr(rng: random.Random, names: List[str], depth: int = 0) -> str:
    """Random scalar expression over scan-body names (no division: inputs
    are uniform random and denominators could vanish)."""
    r = rng.random()
    if depth >= 3 or r < 0.35:
        rr = rng.random()
        if rr < 0.7:
            return rng.choice(names)
        return repr(round(rng.uniform(-1.2, 1.2), 3))
    if r < 0.7:
        op = rng.choice(["+", "-", "*"])
        return (
            f"({_scan_expr(rng, names, depth + 1)} {op} "
            f"{_scan_expr(rng, names, depth + 1)})"
        )
    if r < 0.85:
        return (
            f"where(({_scan_expr(rng, names, depth + 1)}) > 0.25, "
            f"{_scan_expr(rng, names, depth + 1)}, "
            f"{_scan_expr(rng, names, depth + 1)})"
        )
    fn = rng.choice(["minimum", "maximum"])
    return (
        f"{fn}({_scan_expr(rng, names, depth + 1)}, "
        f"{_scan_expr(rng, names, depth + 1)})"
    )


def bridge_case(seed: int, gtx) -> SimpleNamespace:
    """The JAX fuzzer's ``run_bridge_case`` draws for ``seed`` on the
    package ``gtx``: the operator (field operators with helper calls and
    tuple returns, scan operators, K-partitioned ``concat_where``), and
    ``run(backend, field_kw)`` -> its result or an error's type name, and
    the bound operator."""
    rng = random.Random(seed ^ 0x5EED)
    nprng = np.random.default_rng(seed + 424242)

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))

    def register(src: str, tag: str):
        return _register(src, f"<bridge-fuzz-{seed}-{tag}>")

    scan_case = rng.random() < 0.4
    cw_case = not scan_case and rng.random() < 0.35

    if cw_case:
        Koff = gtx.FieldOffset("Koff", source=K, target=(K,))

        def cw_expr(depth=0):
            r = rng.random()
            if depth >= 2 or r < 0.4:
                rr = rng.random()
                if rr < 0.5:
                    nm = rng.choice(["a", "b"])
                    if rng.random() < 0.4:
                        off = rng.choice(["Ioff", "Joff", "Koff"])
                        return f"{nm}({off}[{rng.randint(-2, 2)}])"
                    return nm
                if rr < 0.75:
                    return "s"
                return repr(round(rng.uniform(-1.5, 1.5), 3))
            op2 = rng.choice(["+", "-", "*"])
            return f"({cw_expr(depth + 1)} {op2} {cw_expr(depth + 1)})"

        names = ["a", "b"]
        lines = []
        for i in range(rng.randint(1, 2)):
            c = rng.randint(1, 7)
            rel = rng.choice(["<", "<=", ">", ">="])
            ea = f"({cw_expr()}) + 0.0 * a"
            eb = f"({cw_expr()}) + 0.0 * b"
            lines.append(f"    t{i} = concat_where(K {rel} {c}, {ea}, {eb})")
            names.append(f"t{i}")
        ret = f"({cw_expr()}) + 0.0 * {names[-1]}"
        src = "def op(a: FT3, b: FT3, s: float64):\n" + "\n".join(lines) + f"\n    return {ret}\n"
        ns = dict(
            FT3=gtx.Field[gtx.Dims[I, J, K], np.float64], float64=np.float64,
            where=gtx.where, minimum=gtx.minimum, maximum=gtx.maximum,
            Ioff=Ioff, Joff=Joff, Koff=Koff, K=K, concat_where=gtx.concat_where,
        )
        exec(register(src, "cw"), ns)
        op = gtx.field_operator(ns["op"])
        arrays = [((I, J, K), nprng.random((7, 6, 9))), ((I, J, K), nprng.random((7, 6, 9)))]
        scalars = [np.float64(nprng.uniform(-1, 1))]
    elif scan_case:
        arity = rng.choice([1, 2])
        cnames = ["carry"] if arity == 1 else ["carry[0]", "carry[1]"]
        names = cnames + ["x", "g", "w"]
        if arity == 1:
            ret = _scan_expr(rng, names)
            src = (
                "def sc(carry: float64, x: float64, g: float64, "
                "w: float64) -> float64:\n"
                f"    return {ret}\n"
            )
            init = round(rng.uniform(-1, 1), 3)
        else:
            e0 = _scan_expr(rng, names)
            e1 = _scan_expr(rng, names)
            src = (
                "def sc(carry: tuple[float64, float64], x: float64, "
                "g: float64, w: float64):\n"
                f"    t = {_scan_expr(rng, names)}\n"
                f"    return ({e0} + 0.0 * t, {e1} + 0.0 * t)\n"
            )
            init = (round(rng.uniform(-1, 1), 3), round(rng.uniform(-1, 1), 3))
        ns = dict(float64=np.float64, where=gtx.where, minimum=gtx.minimum,
                  maximum=gtx.maximum)
        exec(register(src, "scan"), ns)
        forward = rng.random() < 0.5
        op = gtx.scan_operator(ns["sc"], axis=K, forward=forward, init=init)
        shape3 = (5, 6, 8)
        x_np = nprng.random(shape3)
        g_has_k = rng.random() < 0.5
        g_np = nprng.random(shape3 if g_has_k else shape3[:2])
        arrays = [((I, J, K), x_np), ((I, J, K) if g_has_k else (I, J), g_np)]
        scalars = [np.float64(nprng.uniform(-1, 1))]
    else:
        gen = OperatorGenerator(rng)
        gen.field_names = {"a", "b"}
        names = ["a", "b"]
        body: List[str] = []
        helper_src = (
            "def helper(x: FT, w: float64) -> FT:\n"
            f"    return ({_scan_expr(rng, ['x', 'w'])}) + 0.0 * x\n"
        )
        hns = dict(
            FT=gtx.Field[gtx.Dims[I, J], np.float64], float64=np.float64,
            where=gtx.where, minimum=gtx.minimum, maximum=gtx.maximum,
        )
        exec(register(helper_src, "helper"), hns)
        helper = gtx.field_operator(hns["helper"])
        for i in range(rng.randint(1, 3)):
            t = f"t{i}"
            if rng.random() < 0.35:
                arg = gen._expr(names)
                if not gen._is_field_expr(arg):
                    arg = f"({arg}) + 0.0 * a"
                body.append(f"{t} = helper({arg}, s)")
                gen.field_names.add(t)
            else:
                e = gen._expr(names)
                body.append(f"{t} = {e}")
                if gen._is_field_expr(e):
                    gen.field_names.add(t)
            names.append(t)
        tuple_ret = rng.random() < 0.4
        if tuple_ret:
            u = gen._expr(names)
            if not gen._is_field_expr(u):
                u = f"({u}) + 0.0 * a"
            body.append(f"u = {u} + 0.0 * (a + b)")
            r2 = rng.random()
            if r2 < 0.3:
                ret = "(u(Ioff[1]) - u, u(Joff[1]) + u)"
            elif r2 < 0.55:
                o1, o2 = rng.choice([(1, 2), (-2, -1), (2, 1), (-1, -2)])
                ret = f"(a(Ioff[{o1}]) + a(Ioff[{o2}]), a + a(Ioff[{o2}]))"
            else:
                ret = f"(u * {round(rng.uniform(0.5, 2.0), 2)} + s, u - s)"
        else:
            ret = gen._expr(names)
            if not gen._is_field_expr(ret):
                ret = f"({ret}) + 0.0 * a"
        src = "def op(a: FT, b: FT, s: float64):\n" + textwrap.indent(
            "\n".join(body + [f"return {ret}"]), "    "
        )
        ns = dict(
            FT=gtx.Field[gtx.Dims[I, J], np.float64], float64=np.float64,
            where=gtx.where, minimum=gtx.minimum, maximum=gtx.maximum,
            Ioff=Ioff, Joff=Joff, helper=helper,
        )
        exec(register(src, "op"), ns)
        op = gtx.field_operator(ns["op"])
        arrays = [((I, J), nprng.random((10, 9))), ((I, J), nprng.random((10, 9)))]
        scalars = [np.float64(nprng.uniform(-1, 1))]

    def run(backend, kw):
        fields = [gtx.as_field(d, a.copy(), **kw) for d, a in arrays]
        bound = op.with_backend(backend)
        try:
            return _result(bound(*fields, *scalars)), bound
        except ValueError as e:
            # the cw family's uncoverable shapes: every path rejects alike
            return type(e).__name__, bound
        except Exception as e:
            if type(e).__name__ == "FieldViewError":
                return type(e).__name__, bound
            raise

    return SimpleNamespace(src=src, run=run)


def run_bridge_case(seed: int, rtol=1e-12, atol=1e-12, device="cpu") -> NextCase:
    """The cuda bridge (next/cuda_bridge.py) leg: the SAME generated
    operator on the numpy oracle, on ``"torch"`` and under
    ``with_backend("cuda")`` on ``device`` -- kernel lowering where
    eligible, the recorded embedded fallback otherwise; values, dims AND
    domains must agree either way.  ``lowered``: the case lowered to
    kernel plans."""
    import gt4py_tpu_torch.next as gtx

    c = bridge_case(seed, gtx)
    case = NextCase(seed, c.src)
    case.results["numpy_oracle"] = c.run("numpy_oracle", {"allocator": "numpy"})[0]
    for label in ("torch", "cuda"):
        count = _CudaCount()
        got, bound = c.run(label, {"device": device})
        if label == "cuda":
            count.done(bound, case)
            plans = {**bound.__dict__.get("_bridge_plans", {}),
                     **bound.__dict__.get("_scan_bridge_plans", {})}
            case.lowered = any(p is not None for p in plans.values())
        case.results[label] = got
        _assert_same(seed, label, case.results["numpy_oracle"], got, rtol, atol, case.src)
    return case
