"""Semi-Lagrangian transport: departure-point interpolation.

Counterpart of ``gt4py_tpu.models.semi_lagrangian``.  Departure points
need data-dependent horizontal gathers, which the stencil DSL does not
express, so the general step is plain PyTorch (``semi_lagrangian_step``,
``_windowed_step``) beside a numpy oracle.  With a bounded displacement
the step is also a stencil, ``make_sl_stencil``: every bilinear corner
lies at a fixed offset, so the gather becomes (2W+2)^2 neighbour reads
weighted by pointwise selects -- one row-form kernel on ``"cuda"``, with
the periodic wrap in its loads.
"""

import linecache
import textwrap

import numpy as np
import torch


def semi_lagrangian_step(q, u, v, dt: float, dx: float = 1.0, dy: float = 1.0, *,
                         max_shift=None):
    """One semi-Lagrangian advection step (first-order trajectories,
    bilinear interpolation, periodic domain) on physical K-leading
    ``(K, NI, NJ)`` tensors without halos.  ``max_shift``: bound on the
    departure displacement in cells; when given, the windowed form
    (``_windowed_step``), else a general gather."""
    if max_shift is not None:
        return _windowed_step(q, u, v, dt, dx, dy, int(max_shift))
    nk, ni, nj = q.shape
    dev = q.device
    ii = torch.arange(ni, dtype=q.dtype, device=dev).reshape(1, ni, 1)
    jj = torch.arange(nj, dtype=q.dtype, device=dev).reshape(1, 1, nj)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)
    i0 = torch.floor(xd)
    j0 = torch.floor(yd)
    wi = (xd - i0).to(q.dtype)
    wj = (yd - j0).to(q.dtype)
    i0 = torch.remainder(i0.to(torch.int64), ni)
    j0 = torch.remainder(j0.to(torch.int64), nj)
    i1 = (i0 + 1) % ni
    j1 = (j0 + 1) % nj
    kk = torch.arange(nk, device=dev).reshape(nk, 1, 1).expand(nk, ni, nj)

    def gather(iidx, jidx):
        return q[kk, iidx.expand(nk, ni, nj), jidx.expand(nk, ni, nj)]

    return ((1 - wi) * (1 - wj) * gather(i0, j0) + (1 - wi) * wj * gather(i0, j1)
            + wi * (1 - wj) * gather(i1, j0) + wi * wj * gather(i1, j1))


def _windowed_step(q, u, v, dt: float, dx: float, dy: float, W: int):
    """Bounded-displacement form: the bilinear corners land within ``W``
    cells of the arrival point, so the gather is a sum over the
    (2W+2)^2 periodic rolls weighted by corner-match masks.
    Out-of-bound displacements clamp to the window edge."""
    nk, ni, nj = q.shape
    dev = q.device
    ii = torch.arange(ni, dtype=q.dtype, device=dev).reshape(1, ni, 1)
    jj = torch.arange(nj, dtype=q.dtype, device=dev).reshape(1, 1, nj)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)
    i0f = torch.floor(xd)
    j0f = torch.floor(yd)
    wi = (xd - i0f).to(q.dtype)
    wj = (yd - j0f).to(q.dtype)
    # wrapped displacement of the low corner, clamped into the window
    half_i, half_j = ni // 2, nj // 2
    di = torch.remainder(i0f.to(torch.int32) - ii.to(torch.int32) + half_i, ni) - half_i
    dj = torch.remainder(j0f.to(torch.int32) - jj.to(torch.int32) + half_j, nj) - half_j
    di = torch.clamp(di, -W, W)
    dj = torch.clamp(dj, -W, W)

    zero = torch.zeros_like(q)
    acc = zero
    for d_i in range(-W, W + 2):
        # weight of I-shift d_i: low corner when di == d_i, high when
        # di == d_i - 1 (the corner above the low one)
        wiw = torch.where(di == d_i, 1.0 - wi, zero) + torch.where(di == d_i - 1, wi, zero)
        qi = torch.roll(q, -d_i, dims=1)
        for d_j in range(-W, W + 2):
            wjw = torch.where(dj == d_j, 1.0 - wj, zero) + torch.where(dj == d_j - 1, wj, zero)
            acc = acc + wiw * wjw * torch.roll(qi, -d_j, dims=2)
    return acc


def make_sl_stencil(dtype, backend="cuda", max_shift: int = 1, **options):
    """The windowed semi-Lagrangian step as a stencil: ``(2W+2)^2``
    ternary-weighted neighbour reads.  ``floor(i + s) == i + floor(s)``
    for an integer i, so the displacement splits per point:
    ``di = floor(-u*dt/dx)``, ``wi`` its fractional part.  Signature:
    ``sl(q, u, v, qout, dtdx=dt/dx, dtdy=dt/dy)``.  ``options``: the
    stencil's build options."""
    from gt4py_tpu_torch.cartesian import gtscript

    W = int(max_shift)
    Field = gtscript.Field[dtype]

    def wterm(axis, a):
        w = "wi" if axis == "i" else "wj"
        d = "di" if axis == "i" else "dj"
        return (
            f"(((1.0 - {w}) if {d} == {float(a)} else 0.0)"
            f" + ({w} if {d} == {float(a - 1)} else 0.0))"
        )

    terms = []
    for a in range(-W, W + 2):
        for b in range(-W, W + 2):
            terms.append(f"({wterm('i', a)} * {wterm('j', b)}) * q[{a}, {b}, 0]")
    body = " + ".join(terms)
    src = textwrap.dedent(
        f"""
        def sl_step(q: Field, u: Field, v: Field, qout: Field, *,
                    dtdx: dtype, dtdy: dtype):
            with computation(PARALLEL), interval(...):
                s = -u * dtdx
                t = -v * dtdy
                dif = floor(s)
                djf = floor(t)
                wi = s - dif
                wj = t - djf
                di = min(max(dif, {float(-W)}), {float(W)})
                dj = min(max(djf, {float(-W)}), {float(W)})
                qout = {body}
        """
    )
    filename = f"<sl-stencil-W{W}-{np.dtype(dtype).name}-torch>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns = {
        "Field": Field,
        "dtype": dtype,
        "computation": gtscript.computation,
        "interval": gtscript.interval,
        "PARALLEL": gtscript.PARALLEL,
        "floor": gtscript.floor,
        "min": min,
        "max": max,
    }
    exec(compile(src, filename, "exec"), ns)
    return gtscript.stencil(
        backend=backend,
        definition=ns["sl_step"],
        name=f"sl_step_w{W}_{np.dtype(dtype).name}",
        literal_precision=32 if np.dtype(dtype).itemsize <= 4 else 64,
        **options,
    )


def semi_lagrangian_step_numpy(q, u, v, dt: float, dx: float = 1.0, dy: float = 1.0):
    """NumPy oracle of ``semi_lagrangian_step`` (the general gather)."""
    nk, ni, nj = q.shape
    ii = np.arange(ni, dtype=q.dtype).reshape(1, ni, 1)
    jj = np.arange(nj, dtype=q.dtype).reshape(1, 1, nj)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)
    i0 = np.floor(xd)
    j0 = np.floor(yd)
    wi = (xd - i0).astype(q.dtype)
    wj = (yd - j0).astype(q.dtype)
    i0 = i0.astype(np.int64) % ni
    j0 = j0.astype(np.int64) % nj
    i1 = (i0 + 1) % ni
    j1 = (j0 + 1) % nj
    kk = np.broadcast_to(np.arange(nk).reshape(nk, 1, 1), (nk, ni, nj))
    i0b = np.broadcast_to(i0, (nk, ni, nj))
    j0b = np.broadcast_to(j0, (nk, ni, nj))
    i1b = np.broadcast_to(i1, (nk, ni, nj))
    j1b = np.broadcast_to(j1, (nk, ni, nj))
    q00 = q[kk, i0b, j0b]
    q01 = q[kk, i0b, j1b]
    q10 = q[kk, i1b, j0b]
    q11 = q[kk, i1b, j1b]
    return (
        (1 - wi) * (1 - wj) * q00
        + (1 - wi) * wj * q01
        + wi * (1 - wj) * q10
        + wi * wj * q11
    )
