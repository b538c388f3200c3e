"""The port's next field-view DSL, embedded, against ``gt4py_tpu.next``.

Every case is one source text defined twice, in a namespace of each
package (its Dimensions, offsets, builtins and decorators), and run on the
same seeded numpy inputs: the JAX package's ``numpy_oracle`` and
``jax_eager`` (on the CPU) against the port's ``torch`` backend.  Values
must agree at rtol 1e-12 in float64 (the bound ``tests/next/
test_pallas_bridge.py`` uses; float32 cases at 1e-6), and result dims and
domains must be equal.  The copied frontend, fvir and type system are held
to the originals on the same sources (``unparse`` of the typed IR), and
both frontends must reject the same bad sources with ``FieldViewError``.
"""

import itertools
import linecache
import textwrap

import numpy as np
import pytest
import torch

import gt4py_tpu.next as jgtx
from gt4py_tpu.next import unparse as j_unparse

import gt4py_tpu_torch.next as pgtx
from gt4py_tpu_torch import config
from gt4py_tpu_torch.next import unparse as p_unparse
from gt4py_tpu_torch.next.frontend import FieldViewError
from gt4py_tpu_torch.next.testing import fields_from_numpy


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points default to the card; these tests ask for
    the CPU."""
    monkeypatch.setattr(config, "DEFAULT_DEVICE", "cpu")


RTOL = {np.float64: 1e-12, np.float32: 1e-6}
_SERIAL = itertools.count()


def namespace(pkg):
    """The names a case's source may use, from ``pkg``."""
    I = pkg.Dimension("I")
    J = pkg.Dimension("J")
    K = pkg.Dimension("K", kind=pkg.DimensionKind.VERTICAL)
    ns = dict(
        I=I, J=J, K=K, np=np,
        Ioff=pkg.FieldOffset("Ioff", source=I, target=(I,)),
        Joff=pkg.FieldOffset("Joff", source=J, target=(J,)),
        Koff=pkg.FieldOffset("Koff", source=K, target=(K,)),
        Field=pkg.Field, Dims=pkg.Dims,
        float64=pkg.float64, float32=pkg.float32, int32=pkg.int32, int64=pkg.int64,
        bool_=pkg.bool_,
        field_operator=pkg.field_operator, scan_operator=pkg.scan_operator,
        program=pkg.program,
    )
    for name in ("where", "astype", "broadcast", "concat_where", "maximum", "minimum", "sqrt",
                 "exp", "log", "sin", "cos", "tanh", "abs", "floor", "ceil", "trunc", "power",
                 "fmod", "isnan", "neg", "arctan", "cbrt", "log2"):
        ns[name] = getattr(pkg, name)
    ns.update(
        FT=pkg.Field[pkg.Dims[I, J, K], np.float64],
        F32=pkg.Field[pkg.Dims[I, J, K], np.float32],
        FIJ=pkg.Field[pkg.Dims[I, J], np.float64],
        FIK=pkg.Field[pkg.Dims[I, K], np.float64],
        FK=pkg.Field[pkg.Dims[K], np.float64],
        FI64=pkg.Field[pkg.Dims[I, J, K], np.int64],
    )
    return ns


JNS = namespace(jgtx)
PNS = namespace(pgtx)


def define(src: str, ns: dict) -> dict:
    """Execute ``src`` in a copy of ``ns`` (registered with linecache, so
    the frontends can read the source back)."""
    src = textwrap.dedent(src)
    filename = f"<torch-next-case-{next(_SERIAL)}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    env = dict(ns)
    exec(compile(src, filename, "exec"), env)
    return env


def both(src: str):
    return define(src, JNS), define(src, PNS)


#: argument spec: (dims names, dtype, shape offset) or a scalar value
def make_args(spec, ns, pkg, seed, kind):
    """Seeded numpy inputs as fields of one package: ``kind`` "numpy"
    (numpy-backed), "jax" (jax arrays) or "torch" (CPU tensors through
    ``fields_from_numpy``)."""
    rng = np.random.default_rng(seed)
    sizes = {"I": 8, "J": 7, "K": 5}
    out = []
    for a in spec:
        if not isinstance(a, tuple):
            out.append(a)
            continue
        dims, dtype, off = a
        arr = rng.random(tuple(sizes[d] for d in dims)) + off
        if np.dtype(dtype).kind == "i":
            arr = np.floor(arr * 20 - 10)
        arr = arr.astype(dtype)
        dd = tuple(ns[d] for d in dims)
        if kind == "torch":
            out.append(fields_from_numpy({"x": arr}, dd, "cpu")["x"])
        elif kind == "numpy":
            out.append(pkg.as_field(dd, arr, allocator="numpy"))
        else:
            out.append(pkg.as_field(dd, arr))
    return out


def assert_same(ref, got, rtol):
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for r, g in zip(refs, gots):
        assert [d.value for d in r.dims] == [d.value for d in g.dims]
        assert [(x.start, x.stop) for x in r.domain.ranges] == \
            [(x.start, x.stop) for x in g.domain.ranges]
        assert np.dtype(r.dtype) == np.dtype(g.dtype)
        np.testing.assert_allclose(g.asnumpy(), np.asarray(r.asnumpy()), rtol=rtol, atol=rtol)


F3 = ("IJK", np.float64, 0.0)
F3B = ("IJK", np.float64, 0.5)
F32 = ("IJK", np.float32, 0.0)

#: field operators: (source, entry, argument spec)
OPERATORS = {
    "laplacian": ("""
        @field_operator
        def op(a: FT) -> FT:
            return 4.0 * a - (a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]))
        """, [F3]),
    "hdiff": ("""
        @field_operator
        def op(inp: FT, coeff: FT) -> FT:
            lap = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
            flx = lap(Ioff[1]) - lap
            flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
            fly = lap(Joff[1]) - lap
            fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
            return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))
        """, [F3, F3]),
    "where_scalars": ("""
        @field_operator
        def op(a: FT, b: FT) -> FT:
            return where(a > b, a, 2.0 * b) + where(b < 0.3, 1.0, 0.0)
        """, [F3, F3]),
    "nested_where": ("""
        @field_operator
        def op(a: FT, b: FT) -> FT:
            return where(a > 0.5, where(b < 0.5, -a, b), where(a < 0.1, b * 2.0, a))
        """, [F3, F3]),
    "astype_float32": ("""
        @field_operator
        def op(a: FT, b: FT) -> F32:
            return astype(a, float32) * astype(b, float32) + astype(a(Ioff[1]), float32)
        """, [F3, F3]),
    "float32_literals": ("""
        @field_operator
        def op(a: F32, b: F32) -> F32:
            return 0.1 * a + b / 3.0 - a * b
        """, [F32, F32]),
    "broadcast_ij": ("""
        @field_operator
        def op(a: FT, c: FIJ) -> FT:
            return a + broadcast(c, (I, J, K)) * 2.0
        """, [F3, ("IJ", np.float64, 0.0)]),
    "broadcast_scalar": ("""
        @field_operator
        def op(a: FT) -> FT:
            return a * broadcast(3.0, (I, J, K))
        """, [F3]),
    "k_field": ("""
        @field_operator
        def op(a: FT, kf: FK) -> FT:
            return a(Koff[1]) + kf
        """, [F3, ("K", np.float64, 0.0)]),
    "ik_field": ("""
        @field_operator
        def op(a: FT, ik: FIK) -> FT:
            return a * ik + ik(Ioff[1])
        """, [F3, ("IK", np.float64, 0.0)]),
    "math": ("""
        @field_operator
        def op(a: FT, b: FT) -> FT:
            t = sqrt(a) + exp(b) - log(a + 1.0) + sin(a) * cos(b) + tanh(a)
            return t + abs(b - a) + floor(a * 3.0) + ceil(b) - trunc(a * 2.5) \\
                + maximum(a, b) - minimum(a, b) + power(a, 2.0) + fmod(b, 0.3) \\
                + arctan(a) + cbrt(b - 0.5) + log2(b)
        """, [F3B, F3B]),
    "tuple_return": ("""
        @field_operator
        def op(a: FT, b: FT):
            return a + b, a - b
        """, [F3, F3]),
    "scalar_param": ("""
        @field_operator
        def op(a: FT, s: float64) -> FT:
            return a * s + 1.0
        """, [F3, np.float64(0.75)]),
    "operator_call": ("""
        @field_operator
        def helper(x: FT, w: float64) -> FT:
            return x(Ioff[1]) * w - x
        @field_operator
        def op(a: FT, b: FT) -> FT:
            return helper(a + b, 0.5) + helper(a, 2.0)(Joff[-1])
        """, [F3, F3]),
    "concat_where": ("""
        @field_operator
        def op(a: FT, b: FT) -> FT:
            return concat_where(K < 2, a, b(Koff[1]) + a)
        """, [F3, F3]),
    "integers": ("""
        @field_operator
        def op(a: FI64, b: FI64) -> FI64:
            return a // 3 + a % 5 - b * 2
        """, [("IJK", np.int64, 0.0), ("IJK", np.int64, 0.0)]),
    "negation": ("""
        @field_operator
        def op(a: FT) -> FT:
            return neg(a) + -a(Joff[1])
        """, [F3]),
}

#: scan operators: (source, argument spec)
SCANS = {
    "cumsum_forward": ("""
        @scan_operator(axis=K, forward=True, init=0.0)
        def op(carry: float64, x: float64) -> float64:
            return carry + x
        """, [F3]),
    "decay_backward": ("""
        @scan_operator(axis=K, forward=False, init=1.0)
        def op(carry: float64, x: float64) -> float64:
            return 0.5 * carry - x
        """, [F3]),
    "tuple_carry": ("""
        @scan_operator(axis=K, forward=True, init=(0.0, 0.0))
        def op(carry: tuple[float64, float64], a: float64, b: float64, c: float64, d: float64):
            denom = b - a * carry[0]
            return (c / denom, (d - a * carry[1]) / denom)
        """, [F3, ("IJK", np.float64, 4.0), F3, F3]),
    "tuple_carry_backward": ("""
        @scan_operator(axis=K, forward=False, init=(1.0, 0.0))
        def op(carry: tuple[float64, float64], x: float64):
            return (carry[0] * 0.5 + x, maximum(carry[1], x))
        """, [F3]),
    "scalar_arg": ("""
        @scan_operator(axis=K, forward=True, init=0.0)
        def op(carry: float64, x: float64, w: float64) -> float64:
            return carry * w + where(x > 0.5, x, 0.0)
        """, [F3, np.float64(0.9)]),
    "ij_arg": ("""
        @scan_operator(axis=K, forward=True, init=0.0)
        def op(carry: float64, x: float64, g: float64) -> float64:
            return carry + x * g
        """, [F3, ("IJ", np.float64, 0.0)]),
}

BACKENDS = {"numpy_oracle": "numpy", "jax_eager": "jax"}


def _run_case(src, spec, jbackend, seed=3):
    jns, pns = both(src)
    ref = jns["op"].with_backend(jbackend)(*make_args(spec, jns, jgtx, seed, BACKENDS[jbackend]))
    got = pns["op"].with_backend("torch")(*make_args(spec, pns, pgtx, seed, "torch"))
    return ref, got


def _rtol(spec):
    return RTOL[np.float32] if any(isinstance(a, tuple) and a[1] == np.float32 for a in spec) \
        or "F32" in spec else RTOL[np.float64]


@pytest.mark.parametrize("jbackend", list(BACKENDS))
@pytest.mark.parametrize("name", list(OPERATORS))
def test_field_operator_torch_vs_jax(name, jbackend):
    src, spec = OPERATORS[name]
    ref, got = _run_case(src, spec, jbackend)
    rtol = RTOL[np.float32] if "F32" in src else RTOL[np.float64]
    assert_same(ref, got, rtol)
    for g in (got if isinstance(got, tuple) else (got,)):
        assert isinstance(g.data, torch.Tensor)


@pytest.mark.parametrize("jbackend", list(BACKENDS))
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_operator_torch_vs_jax(name, jbackend):
    src, spec = SCANS[name]
    ref, got = _run_case(src, spec, jbackend)
    assert_same(ref, got, RTOL[np.float64])


def test_embedded_follows_the_fields_namespace():
    """With no backend, numpy fields stay numpy and tensors stay tensors."""
    _, pns = both(OPERATORS["hdiff"][0])
    op = pns["op"]
    t_args = make_args([F3, F3], pns, pgtx, 1, "torch")
    n_args = make_args([F3, F3], pns, pgtx, 1, "numpy")
    got_t, got_n = op(*t_args), op(*n_args)
    assert isinstance(got_t.data, torch.Tensor) and isinstance(got_n.data, np.ndarray)
    np.testing.assert_allclose(got_t.asnumpy(), got_n.asnumpy(), rtol=1e-12)


def test_constructors_keep_k_outermost():
    """(I, J, K) fields from the constructors are views over (K, I, J)
    storage: J contiguous, as the kernels read them."""
    ns = PNS
    dims = (ns["I"], ns["J"], ns["K"])
    for f in (pgtx.zeros({d: n for d, n in zip(dims, (4, 5, 3))}, device="cpu"),
              pgtx.as_field(dims, np.arange(60.0).reshape(4, 5, 3), device="cpu")):
        assert f.data.shape == (4, 5, 3)
        assert f.data.stride() == (5, 1, 20)
    np.testing.assert_array_equal(pgtx.as_field(dims, np.arange(60.0).reshape(4, 5, 3)).asnumpy(),
                                  np.arange(60.0).reshape(4, 5, 3))
    t = torch.arange(60.0).reshape(4, 5, 3)
    assert pgtx.as_field(dims, t).data.data_ptr() == t.data_ptr()  # shared, as given


# --------------------------------------------------------------------- #
# programs: out=, domain=, out slices
# --------------------------------------------------------------------- #

PROGRAMS = {
    "hdiff_prog": """
        @field_operator
        def lap_op(inp: FT) -> FT:
            return 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
        @field_operator
        def flx_op(inp: FT, lap: FT) -> FT:
            fx = lap(Ioff[1]) - lap
            return where(fx * (inp(Ioff[1]) - inp) > 0.0, 0.0, fx)
        @field_operator
        def fly_op(inp: FT, lap: FT) -> FT:
            fy = lap(Joff[1]) - lap
            return where(fy * (inp(Joff[1]) - inp) > 0.0, 0.0, fy)
        @field_operator
        def out_op(inp: FT, fx: FT, fy: FT, coeff: FT) -> FT:
            return inp - coeff * (fx - fx(Ioff[-1]) + fy - fy(Joff[-1]))
        @program
        def prog(inp: FT, coeff: FT, lap: FT, fx: FT, fy: FT, res: FT):
            lap_op(inp, out=lap)
            flx_op(inp, lap, out=fx)
            fly_op(inp, lap, out=fy)
            out_op(inp, fx, fy, coeff, out=res)
        """,
    "mixed_prog": """
        @field_operator
        def lap_op(inp: FT) -> FT:
            return 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
        @scan_operator(axis=K, forward=True, init=0.0)
        def integ(carry: float64, x: float64) -> float64:
            return carry * 0.9 + x
        @field_operator
        def upd(inp: FT, acc: FT) -> FT:
            return inp - 0.1 * acc
        @program
        def prog(inp: FT, coeff: FT, lap: FT, fx: FT, fy: FT, res: FT):
            lap_op(inp, out=lap)
            integ(lap, out=fx)
            upd(inp, fx, out=res)
        """,
    "domain_and_slices": """
        @field_operator
        def scale(a: FT, s: float64) -> FT:
            return a * s + a(Koff[1])
        @field_operator
        def flat(a: FT, s: float64) -> FT:
            return a * s - a(Ioff[1])
        @program
        def prog(inp: FT, coeff: FT, lap: FT, fx: FT, fy: FT, res: FT):
            scale(inp, 2.0, out=lap, domain={I: (3, 7), J: (4, 9), K: (0, 3)})
            flat(coeff, 0.5, out=fx[1:-1, :, :])
            scale(inp, 1.5, out=res, domain={I: (2, 9), J: (3, 10), K: (1, 4)})
        """,
}

#: program field domains: (I, J) lower/upper halo around the interior
#: I [2, 9), J [3, 10), K [0, 5) of an (11, 13, 5) input
#: (the mixed program's intermediates cover the interior only, as in
#: bench.py, so its scan statement joins the fused segment)
PROGRAM_FIELDS = {"inp": (2, 2, 3, 3), "coeff": (2, 2, 3, 3), "lap": (1, 1, 1, 1),
                  "fx": (1, 0, 0, 0), "fy": (0, 0, 1, 0), "res": (0, 0, 0, 0)}
INTERIOR = dict(PROGRAM_FIELDS, lap=(0, 0, 0, 0), fx=(0, 0, 0, 0))


def program_args(ns, pkg, kind, seed=5, layout=PROGRAM_FIELDS):
    rng = np.random.default_rng(seed)
    U, D = pkg.common.UnitRange, pkg.common.Domain
    out = []
    for name, (ilo, ihi, jlo, jhi) in layout.items():
        dom = D((ns["I"], ns["J"], ns["K"]), (U(2 - ilo, 9 + ihi), U(3 - jlo, 10 + jhi), U(0, 5)))
        arr = rng.random(dom.shape) if name in ("inp", "coeff") else np.zeros(dom.shape)
        if kind == "numpy":
            data = arr
        elif kind == "jax":
            import jax.numpy as jnp

            data = jnp.asarray(arr)
        else:
            data = pgtx.as_field(dom.dims, arr, device="cpu").data
        out.append(pkg.Field(dom, data))
    return out


def run_program(name, jbackend, pbackend, fusion=True):
    from gt4py_tpu import config as jconfig
    from gt4py_tpu_torch import config as pconfig

    jns, pns = both(PROGRAMS[name])
    layout = INTERIOR if name == "mixed_prog" else PROGRAM_FIELDS
    jargs = program_args(jns, jgtx, BACKENDS.get(jbackend, "jax"), layout=layout)
    pargs = program_args(pns, pgtx, "torch", layout=layout)
    old = jconfig.PROGRAM_FUSION, pconfig.PROGRAM_FUSION
    jconfig.PROGRAM_FUSION = pconfig.PROGRAM_FUSION = fusion
    try:
        jns["prog"].with_backend(jbackend)(*jargs)
        prog = pns["prog"].with_backend(pbackend)
        prog(*pargs)
    finally:
        jconfig.PROGRAM_FUSION, pconfig.PROGRAM_FUSION = old
    return jargs, pargs, prog


@pytest.mark.parametrize("jbackend", list(BACKENDS))
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_torch_vs_jax(name, jbackend):
    jargs, pargs, _ = run_program(name, jbackend, "torch")
    for j, p in zip(jargs, pargs):
        assert_same(j, p, RTOL[np.float64])


def test_program_bound_and_static_args():
    """``with_bound_args`` fixes parameters; ``with_static_params`` +
    ``compile`` plans a variant (nothing to build on CPU fields)."""
    src = """
        @field_operator
        def scale(a: FT, s: float64) -> FT:
            return a * s
        @program
        def prog(a: FT, s: float64, out: FT):
            scale(a, s, out=out)
        """
    jns, pns = both(src)
    spec = [F3, ("IJK", np.float64, 0.0)]
    ja, jo = make_args(spec, jns, jgtx, 2, "numpy")
    pa, po = make_args(spec, pns, pgtx, 2, "torch")
    jns["prog"].with_backend("numpy_oracle").with_bound_args(s=np.float64(3.0))(ja, out=jo)
    prog = pns["prog"].with_backend("cuda").with_static_params("s")
    prog.compile((pa, po), s=[np.float64(3.0)], wait=True)
    assert len(prog._pool.compiled_keys) == 1
    prog.with_bound_args(s=np.float64(3.0))(pa, out=po)
    assert_same(jo, po, RTOL[np.float64])


# --------------------------------------------------------------------- #
# the copied language layers, and their error paths
# --------------------------------------------------------------------- #

ALL_SOURCES = {**{f"op_{k}": v[0] for k, v in OPERATORS.items()},
               **{f"scan_{k}": v[0] for k, v in SCANS.items()},
               **{f"prog_{k}": v for k, v in PROGRAMS.items()}}


@pytest.mark.parametrize("name", sorted(ALL_SOURCES))
def test_frontend_copy_gives_the_same_typed_ir(name):
    jns, pns = both(ALL_SOURCES[name])
    key = "prog" if name.startswith("prog_") else "op"
    j, p = jns[key], pns[key]
    assert p_unparse.unparse(p._decl_typed) == j_unparse.unparse(j._decl_typed)
    assert str(p) == str(j)


BAD_SOURCES = {
    "undefined_name": """
        @field_operator
        def op(a: FT) -> FT:
            return a + missing
        """,
    "for_loop": """
        @field_operator
        def op(a: FT) -> FT:
            for i in range(3):
                a = a + 1.0
            return a
        """,
    "mixed_precision": """
        @field_operator
        def op(a: FT, b: F32) -> FT:
            return a + b
        """,
    "wrong_return": """
        @field_operator
        def op(a: FT) -> F32:
            return a
        """,
    "shift_unknown_dim": """
        @field_operator
        def op(a: FK) -> FK:
            return a(Ioff[1])
        """,
    "call_arity": """
        @field_operator
        def scale(a: FT) -> FT:
            return 2.0 * a
        @field_operator
        def op(a: FT) -> FT:
            return scale(a, a)
        """,
    "scan_carry_type": """
        @scan_operator(axis=K, forward=True, init=0.0)
        def op(carry: float64, x: float64) -> float32:
            return carry + x
        """,
}


@pytest.mark.parametrize("name", sorted(BAD_SOURCES))
def test_frontend_errors_match(name):
    outcome = []
    for ns in (JNS, PNS):
        try:
            define(BAD_SOURCES[name], ns)
            outcome.append(None)
        except Exception as ex:  # the exception type and message are compared
            outcome.append((type(ex).__name__, str(ex).splitlines()[0]))
    assert outcome[0] is not None and outcome[0][0] == "FieldViewError"
    assert outcome[1] == outcome[0]


# --------------------------------------------------------------------- #
# unstructured: remap through a connectivity, neighbor reductions
# --------------------------------------------------------------------- #

#: vertex -> edge table of a 3 x 3 vertex patch (-1: no neighbour)
V2E_TABLE = np.array([[0, 1, -1, -1], [1, 2, 3, -1], [2, 4, -1, 5], [6, 3, 7, 0],
                      [7, 8, 4, 9], [8, 5, 10, -1], [6, 11, -1, 9], [11, 10, 12, -1],
                      [12, -1, -1, 13]])


def unstructured_ns(pkg):
    V, E = pkg.Dimension("Vertex"), pkg.Dimension("Edge")
    V2EDim = pkg.Dimension("V2E", kind=pkg.DimensionKind.LOCAL)
    conn = pkg.as_connectivity(V2E_TABLE, source=V, codomain=E, local_dim=V2EDim,
                               skip_value=-1)
    return dict(namespace(pkg), V=V, E=E, V2EDim=V2EDim, V2E=conn,
                neighbor_sum=pkg.neighbor_sum, max_over=pkg.max_over,
                min_over=pkg.min_over, FE=pkg.Field[pkg.Dims[E], np.float64],
                FV=pkg.Field[pkg.Dims[V], np.float64])


UNSTRUCTURED = """
    @field_operator
    def op(e: FE) -> FV:
        return neighbor_sum(e(V2E), axis=V2EDim) + max_over(e(V2E), axis=V2EDim) \\
            - min_over(e(V2E), axis=V2EDim) * 2.0
    """


@pytest.mark.parametrize("jbackend", list(BACKENDS))
def test_unstructured_remap_and_reductions_torch_vs_jax(jbackend):
    jns, pns = define(UNSTRUCTURED, unstructured_ns(jgtx)), define(UNSTRUCTURED,
                                                                   unstructured_ns(pgtx))
    e = np.random.default_rng(8).random(14)
    alloc = "numpy" if jbackend == "numpy_oracle" else None
    ref = jns["op"].with_backend(jbackend)(jgtx.as_field((jns["E"],), e, allocator=alloc))
    got = pns["op"].with_backend("torch")(pgtx.as_field((pns["E"],), e, device="cpu"))
    assert_same(ref, got, RTOL[np.float64])


def test_inspection_describes_the_lowered_kernels():
    from gt4py_tpu_torch.next import inspection

    _, pns = both(OPERATORS["hdiff"][0])
    args = make_args([F3, F3], pns, pgtx, 0, "torch")
    text = inspection.describe(pns["op"], *args)
    assert "Field<I[0:8], J[0:7], K[0:5]; float64>" in text
    # the hdiff operator's PARALLEL section is one tile kernel
    assert "tile form (PARALLEL)" in text


def test_keyword_and_positional_calls_agree():
    """Arguments bind as in a Python call: keywords in any order."""
    src, spec = OPERATORS["hdiff"]
    _, pns = both(src)
    a, c = make_args(spec, pns, pgtx, 4, "torch")
    op = pns["op"].with_backend("torch")
    ref = op(a, c)
    for got in (op(inp=a, coeff=c), op(coeff=c, inp=a), op(a, coeff=c)):
        assert_same(ref, got, 0.0)
    with pytest.raises(TypeError):
        op(a, c, coeff=c)


def test_program_domain_inference_errors_match():
    """A statement whose inputs cannot cover the ``out=`` field raises the
    same located error in both packages (extents.required_domains)."""
    src = """
        @field_operator
        def shift(a: FT) -> FT:
            return a(Ioff[1])
        @program
        def prog(a: FT, out: FT):
            shift(a, out=out)
        """
    outcome = []
    for ns, pkg, kind in ((JNS, jgtx, "numpy"), (PNS, pgtx, "torch")):
        env = define(src, ns)
        a, out = make_args([F3, F3], env, pkg, 0, kind)
        try:
            env["prog"](a, out)
            outcome.append(None)
        except Exception as ex:  # the exception type and message are compared
            outcome.append((type(ex).__name__, str(ex).splitlines()[0]))
    assert outcome[0] is not None and outcome[1] == outcome[0]


#: a scan defined inside a function whose carry annotation names a local
#: alias, in a module with and without ``from __future__ import annotations``
LOCAL_ALIAS_SCAN = """
def make():
    Carry = float32

    @scan_operator(axis=K, forward=True, init=0.0)
    def acc(state: Carry, x: Carry) -> Carry:
        return state * 0.5 + x

    return acc
"""


def test_future_annotations_scan_with_a_local_alias():
    """String annotations resolve against the decorating frame's locals: the
    scan types and runs as float32, equal to the one written without the
    future import."""
    deferred = define("from __future__ import annotations\n" + LOCAL_ALIAS_SCAN, PNS)["make"]()
    eager = define(LOCAL_ALIAS_SCAN, PNS)["make"]()
    for op in (deferred, eager):
        assert str(op.ir.params[0].type) == "float32", op.ir.params
    (x,) = make_args([F32], PNS, pgtx, 3, "torch")
    a, b = deferred(x), eager(x)
    assert a.data.dtype == torch.float32
    assert torch.equal(a.data, b.data)


def test_unresolvable_string_annotation_names_it():
    src = """
    from __future__ import annotations

    def make():
        @scan_operator(axis=K, forward=True, init=0.0)
        def acc(state: NoSuchCarry, x: float32) -> float32:
            return state + x

        return acc
    """
    make = define(src, PNS)["make"]
    with pytest.raises(FieldViewError, match="NoSuchCarry"):
        make()
