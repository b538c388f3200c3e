"""The constructs K8's derivative stencils once declined, as definitions.

Writes at a K offset (parallel, and serial upward and downward in both
sweep directions; a field written at two offsets in one serial loop, or at
an offset and read at an absolute K), writes to a data-dimension
component, lower-dimensional fields read with their gradient wanted and
written (I-J once, and summed over a column; I, K, I-K and J-K fields; an
I-J field with data dimensions), run-time interval bounds, and absolute- and
variable-K reads of a field the stencil writes.  ``SOURCE`` is one text that ``build`` makes into
either package's definitions (the tests build the JAX package's twins from
it); ``CASES`` says what each differentiates; ``inputs`` draws a call's
buffers.  The CPU tests (``tests/test_torch_derivative_constructs.py``) and
the chip check's phase 9 run them.
"""

import linecache
from typing import Dict

import numpy as np

#: the definitions; ``{pkg}`` is the package, ``{dtype}`` the float type
SOURCE = '''
import numpy as np
from {pkg}.cartesian import gtscript
from {pkg}.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

F = gtscript.Field[{dtype}]
IJ = gtscript.Field[gtscript.IJ, {dtype}]
V3 = gtscript.Field[({dtype}, (3,))]
I1 = gtscript.Field[gtscript.I, {dtype}]
K1 = gtscript.Field[gtscript.K, {dtype}]
IK = gtscript.Field[gtscript.IK, {dtype}]
JK = gtscript.Field[gtscript.JK, {dtype}]
IJ2 = gtscript.Field[gtscript.IJ, ({dtype}, (2,))]


def offset_write_parallel(a: F, b: F, out: F):
    with computation(PARALLEL), interval(0, -1):
        out[0, 0, 1] = a * a + b[1, 0, 0]


def offset_write_forward_up(a: F, b: F, out: F, c: F):
    with computation(FORWARD), interval(0, -1):
        out[0, 0, 1] = out * a + b
        c = out * out[0, 0, 1] + a


def offset_write_forward_down(a: F, b: F, out: F):
    with computation(FORWARD), interval(1, None):
        out[0, 0, -1] = out * a + b * out[0, 0, -1]


def offset_write_backward_down(a: F, b: F, out: F):
    with computation(BACKWARD), interval(1, None):
        out[0, 0, -1] = out * a + b


def offset_write_backward_up(a: F, b: F, out: F, c: F):
    with computation(BACKWARD), interval(0, -1):
        out[0, 0, 1] = out * a + b * out[0, 0, 1]
        c = out[0, 0, 1] * b


def offset_write_two_shifts(a: F, b: F, out: F, c: F):
    with computation(FORWARD), interval(1, -1):
        out[0, 0, -1] = out[0, 0, -1] * b + a
        out = out[0, 0, -1] * a + b[0, 0, 1]
    with computation(BACKWARD), interval(1, -1):
        c = c[0, 0, 1] * a + out
        c[0, 0, 1] = c * b + c[0, 0, 1]


def offset_write_then_absolute_k(a: F, m: F, out: F):
    with computation(FORWARD), interval(0, -1):
        m[0, 0, 1] = m * 0.5 + 1.0
        out = m.at(K=1) * a + m * out
    with computation(PARALLEL), interval(...):
        out = out + m.at(K=2) * a


def data_dim_write(a: F, w: V3, v: V3, out: F):
    with computation(PARALLEL), interval(...):
        v[0, 0, 0][1] = a * w[1, 0, 0][2]
        out = v[0, 0, 0][1] * v[0, 0, 0][0] + v[0, 0, 0][-1]
    with computation(PARALLEL), interval(...):
        v[0, 0, 0][-1] = out * w[0, 0, 0][1]


def data_dim_write_scan(a: F, v: V3, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            v[0, 0, 0][2] = a * v[0, 0, 0][0]
        with interval(1, None):
            v[0, 0, 0][2] = v[0, 0, -1][2] * a + v[0, 0, 0][1]
            v[0, 0, 0][0] = v[0, 0, 0][2] * v[0, 0, 0][0]
    with computation(PARALLEL), interval(...):
        out = v[0, 0, 0][0] + v[0, 0, 0][2] * a


def lower_dim_read(a: F, b: IJ, out: F):
    with computation(PARALLEL), interval(...):
        out = a * b + b[1, 0] * b[0, -1]


def lower_dim_write(a: F, b: IJ, out: F):
    with computation(PARALLEL), interval(...):
        tmp = a * a
    with computation(FORWARD), interval(0, 1):
        b = b * tmp + a
    with computation(PARALLEL), interval(...):
        out = b * a + tmp[1, 0, 0]


def lower_dim_column_sum(a: F, b: F, s: IJ, out: F):
    with computation(FORWARD), interval(...):
        s = s * b + a * a
        out = s * a
    with computation(PARALLEL), interval(...):
        out = out + s * b[0, 1, 0]


def i_field_write(a: F, g: I1, f: I1, out: F):
    with computation(FORWARD), interval(...):
        f = f * g + g
        out = f * a + g[1]


def k_field_write(a: F, g: K1, kf: K1, out: F):
    with computation(FORWARD), interval(1, None):
        kf = kf[-1] * g + g * g
        out = kf * a + g[-1]


def ik_field_write(a: F, g: IK, f: IK, out: F):
    with computation(FORWARD), interval(1, None):
        f = f[0, -1] * g + g[1, 0]
        out = f * a[1, 0, 0] + g


def jk_field_write(a: F, g: JK, f: JK, out: F):
    with computation(PARALLEL), interval(...):
        f = f * g + g[1, 0]
    with computation(BACKWARD), interval(0, -1):
        f = f[0, 1] * g + f
        out = f * a + a[0, 1, 0] * g


def ij_data_dim_write(a: F, b: F, w: IJ2, out: F):
    with computation(FORWARD), interval(...):
        w[0, 0][1] = w[0, 0][1] * b + a * w[0, 0][0]
        out = w[0, 0][1] * a + w[0, 0][0]
        w[0, 0][0] = w[0, 0][0] * b - out * 0.25
    with computation(PARALLEL), interval(...):
        out = out + w[0, 0][1] * b + w[0, 0][0]


def runtime_interval(a: F, b: F, out: F, *, k0: int, k1: int):
    with computation(PARALLEL), interval(k0, k1):
        out = a * a + b[0, 0, 1]


def runtime_interval_scan(a: F, out: F, *, k1: int):
    with computation(FORWARD):
        with interval(0, 1):
            out = a
        with interval(1, k1):
            out = out[0, 0, -1] * a + a


def absolute_k_written(a: F, m: F, out: F):
    with computation(PARALLEL), interval(...):
        t = m * m + 1.0
    with computation(PARALLEL), interval(...):
        out = t.at(K=1) * a + t * a


def variable_k_written(a: F, m: F, kidx: gtscript.Field[np.int64], out: F):
    with computation(PARALLEL), interval(1, None):
        t = m * 2.0
    with computation(FORWARD), interval(...):
        out = t[0, 0, kidx] * a + out[0, 0, 0]
        t = t * m + 1.0
'''

#: name -> (the inputs whose gradient is taken, the scalars); every one
#: also runs periodic in I and J
CASES = {
    # writes at a K offset (once OFFSET_WRITE)
    "offset_write_parallel": (("a", "b", "out"), {}),
    "offset_write_forward_up": (("a", "b", "out", "c"), {}),
    "offset_write_forward_down": (("a", "b", "out"), {}),
    "offset_write_backward_down": (("a", "b", "out"), {}),
    "offset_write_backward_up": (("a", "b", "out", "c"), {}),
    # a field written at two K offsets in one serial loop, or at an offset
    # and read at an absolute K
    "offset_write_two_shifts": (("a", "b", "out", "c"), {}),
    "offset_write_then_absolute_k": (("a", "out"), {}),
    # data-dimension components (once DATA_DIM_WRITE)
    "data_dim_write": (("a", "w", "v", "out"), {}),
    "data_dim_write_scan": (("a", "v", "out"), {}),
    # lower-dimensional fields (once LOWER_DIM)
    "lower_dim_read": (("a", "b", "out"), {}),
    "lower_dim_write": (("a", "b", "out"), {}),
    "lower_dim_column_sum": (("a", "b", "s", "out"), {}),
    # written fields that lack I or J, or have data dimensions and lack K
    "i_field_write": (("a", "g", "f", "out"), {}),
    "k_field_write": (("a", "g", "kf", "out"), {}),
    "ik_field_write": (("a", "g", "f", "out"), {}),
    "jk_field_write": (("a", "g", "f", "out"), {}),
    "ij_data_dim_write": (("a", "b", "w", "out"), {}),
    # run-time interval bounds (once RUNTIME_INTERVAL)
    "runtime_interval": (("a", "b", "out"), {"k0": 1, "k1": 4}),
    "runtime_interval_scan": (("a", "out"), {"k1": 3}),
    # variable- and absolute-K reads of written fields (once
    # VARIABLE_K_WRITTEN)
    "absolute_k_written": (("a", "out"), {}),
    "variable_k_written": (("a", "out"), {}),
}

#: one definition a construct: the emulated kernels' legs and the card's
CHIP = ("offset_write_forward_up", "offset_write_backward_down", "offset_write_two_shifts",
        "offset_write_then_absolute_k", "data_dim_write_scan", "lower_dim_read",
        "lower_dim_write", "i_field_write", "k_field_write", "ik_field_write", "jk_field_write",
        "ij_data_dim_write", "runtime_interval", "variable_k_written")


def build(pkg: str = "gt4py_tpu_torch", dtype: str = "float64") -> Dict[str, object]:
    """``SOURCE``'s definitions for the package ``pkg`` with fields of
    ``dtype``: name -> function (the frontend reads their source through
    linecache)."""
    src = SOURCE.format(pkg=pkg, dtype=f"np.{dtype}")
    filename = f"<derivative-constructs:{pkg}:{dtype}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns: dict = {"__name__": f"derivative_constructs_{pkg}_{dtype}"}
    exec(compile(src, filename, "exec", dont_inherit=True), ns)
    return {name: ns[name] for name in CASES}


def inputs(analysis, domain, seed: int, dtype=np.float64):
    """A call's buffers on ``domain`` (origin (1, 1, 0), one point of halo
    on each side in I and J, one level above): numpy (I, J, K, *data)
    arrays of every field, the written fields' weights (the loss's
    cotangents), from ``seed``.  Integer fields (variable-K offsets) lie in
    [0, 3)."""
    shape = (domain[0] + 2, domain[1] + 2, domain[2] + 1)
    rng = np.random.default_rng(seed)
    fields = {}
    for arg, decl in analysis.stencil.field_decls.items():
        s = tuple(n for n, has in zip(shape, decl.dimensions) if has) + tuple(decl.data_dims)
        if decl.dtype.kind == "i":
            fields[arg] = rng.integers(0, 3, s)
        else:
            fields[arg] = (0.5 + 0.5 * rng.random(s)).astype(dtype)
    written = [n for n, i in analysis.field_info.items() if i.access.value & 2]
    weights = {n: rng.random(fields[n].shape).astype(dtype) for n in written}
    return fields, weights


ORIGIN = (1, 1, 0)
