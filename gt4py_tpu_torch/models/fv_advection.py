"""FVTP2D-style finite-volume advection with monotone PPM flux limiters.

Counterpart of ``gt4py_tpu.models.fv_advection``: the same GTScript
definitions (Lin & Rood (1996) inner/outer operator splitting, PPM
reconstruction, the Colella-Woodward monotonicity limiter), composed over
torch tensors in the physical (K, I, J) layout.  With ``backend="cuda"``
each stencil runs as generated CUDA kernels on CUDA tensors; the single
stencil of a step, ``fv_step``, splits into row-form stages with its
temporaries in scratch tensors or registers.
"""

# NOTE: no ``from __future__ import annotations`` here -- stencil parameter
# annotations must evaluate eagerly (closure-local Field descriptors).

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

from .dycore import (
    ORIGIN_I,
    ORIGIN_J,
    _literal_precision,
    aligned_field_shape,
    periodic_fill,
    state_from_numpy,
)


def make_xflux(dtype, backend="cuda"):
    """PPM flux in I: ``flux[i]`` is the transport through face i
    (between cells i-1 and i), given the face Courant number ``cx``."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"ppm_xflux_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def xflux(q: Field, cx: Field, flux: Field):
        with computation(PARALLEL), interval(...):
            # 4th-order edge interpolation: al at face i (left edge of cell i)
            al = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            # edge deviations of cell i
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[1, 0, 0] - q[0, 0, 0]
            # Colella-Woodward monotone limiter
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            # PPM flux integral through face i for both wind directions
            fpos = (q[-1, 0, 0] + brm[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[-1, 0, 0] - a6l[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            flux = cx[0, 0, 0] * (fpos if cx[0, 0, 0] >= 0.0 else fneg)

    return xflux


def make_yflux(dtype, backend="cuda"):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"ppm_yflux_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def yflux(q: Field, cy: Field, flux: Field):
        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[0, 1, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[0, -1, 0] + brm[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, -1, 0] - a6l[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            flux = cy[0, 0, 0] * (fpos if cy[0, 0, 0] >= 0.0 else fneg)

    return yflux


def make_x_advect(dtype, backend="cuda", factor=1.0):
    """Fused PPM x-flux + divergence update (the flux is a temporary)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_xadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def x_advect(q: Field, cx: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[1, 0, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[-1, 0, 0] + brm[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[-1, 0, 0] - a6l[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            flux = cx[0, 0, 0] * (fpos if cx[0, 0, 0] >= 0.0 else fneg)
            qout = q[0, 0, 0] - FACTOR * (flux[1, 0, 0] - flux[0, 0, 0])

    return x_advect


def make_y_advect(dtype, backend="cuda", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_yadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def y_advect(q: Field, cy: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[0, 1, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[0, -1, 0] + brm[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, -1, 0] - a6l[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            flux = cy[0, 0, 0] * (fpos if cy[0, 0, 0] >= 0.0 else fneg)
            qout = q[0, 0, 0] - FACTOR * (flux[0, 1, 0] - flux[0, 0, 0])

    return y_advect


def make_xy_advect(dtype, backend="cuda", factor=1.0):
    """Both inner half-advections in one stencil (two outputs)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_xyadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def xy_advect(q: Field, cx: Field, cy: Field, qx: Field, qy: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            # x half-advection -> qx
            alx = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            blx = alx[0, 0, 0] - q[0, 0, 0]
            brx = alx[1, 0, 0] - q[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (q[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (q[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fluxx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            qx = q[0, 0, 0] - FACTOR * (fluxx[1, 0, 0] - fluxx[0, 0, 0])
            # y half-advection -> qy
            aly = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bly = aly[0, 0, 0] - q[0, 0, 0]
            bry = aly[0, 1, 0] - q[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (q[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (q[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fluxy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qy = q[0, 0, 0] - FACTOR * (fluxy[0, 1, 0] - fluxy[0, 0, 0])

    return xy_advect


def make_fv_step(dtype, backend="cuda", **options):
    """The whole Lin-Rood split step in one stencil: the cross-advected
    fields qx/qy and every PPM flux are temporaries.  Reads q, cx, cy and
    writes qout.  On ``"cuda"`` it splits into row-form stages at each
    offset read of a temporary written earlier in the stage (with
    ``options`` ``serialize=True``: one plane-sweep kernel)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_step_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def fv_step(q: Field, cx: Field, cy: Field, qout: Field):
        with computation(PARALLEL), interval(...):
            # inner x half-advection -> qx (temporary, j-extent +-3)
            alx = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            blx = alx[0, 0, 0] - q[0, 0, 0]
            brx = alx[1, 0, 0] - q[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (q[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (q[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fluxx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            qx = q[0, 0, 0] - 0.5 * (fluxx[1, 0, 0] - fluxx[0, 0, 0])
            # inner y half-advection -> qy (temporary, i-extent +-3)
            aly = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bly = aly[0, 0, 0] - q[0, 0, 0]
            bry = aly[0, 1, 0] - q[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (q[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (q[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fluxy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qy = q[0, 0, 0] - 0.5 * (fluxy[0, 1, 0] - fluxy[0, 0, 0])
            # outer stage: x flux on qy
            alfx = 7.0 / 12.0 * (qy[-1, 0, 0] + qy[0, 0, 0]) - 1.0 / 12.0 * (
                qy[-2, 0, 0] + qy[1, 0, 0]
            )
            blfx = alfx[0, 0, 0] - qy[0, 0, 0]
            brfx = alfx[1, 0, 0] - qy[0, 0, 0]
            dmfx = brfx - blfx
            a6fx = -3.0 * (blfx + brfx)
            smfx = blfx * brfx < 0.0
            blmfx = (-2.0 * brfx if dmfx * a6fx > dmfx * dmfx else blfx) if smfx else 0.0
            brmfx = (-2.0 * blfx if dmfx * a6fx < -dmfx * dmfx else brfx) if smfx else 0.0
            dmlfx = brmfx - blmfx
            a6lfx = -3.0 * (blmfx + brmfx)
            fpfx = (qy[-1, 0, 0] + brmfx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlfx[-1, 0, 0] - a6lfx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnfx = (qy[0, 0, 0] + blmfx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlfx[0, 0, 0] + a6lfx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fx = cx[0, 0, 0] * (fpfx if cx[0, 0, 0] >= 0.0 else fnfx)
            # outer stage: y flux on qx
            alfy = 7.0 / 12.0 * (qx[0, -1, 0] + qx[0, 0, 0]) - 1.0 / 12.0 * (
                qx[0, -2, 0] + qx[0, 1, 0]
            )
            blfy = alfy[0, 0, 0] - qx[0, 0, 0]
            brfy = alfy[0, 1, 0] - qx[0, 0, 0]
            dmfy = brfy - blfy
            a6fy = -3.0 * (blfy + brfy)
            smfy = blfy * brfy < 0.0
            blmfy = (-2.0 * brfy if dmfy * a6fy > dmfy * dmfy else blfy) if smfy else 0.0
            brmfy = (-2.0 * blfy if dmfy * a6fy < -dmfy * dmfy else brfy) if smfy else 0.0
            dmlfy = brmfy - blmfy
            a6lfy = -3.0 * (blmfy + brmfy)
            fpfy = (qx[0, -1, 0] + brmfy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmlfy[0, -1, 0] - a6lfy[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnfy = (qx[0, 0, 0] + blmfy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmlfy[0, 0, 0] + a6lfy[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fy = cy[0, 0, 0] * (fpfy if cy[0, 0, 0] >= 0.0 else fnfy)
            qout = (
                q[0, 0, 0]
                - (fx[1, 0, 0] - fx[0, 0, 0])
                - (fy[0, 1, 0] - fy[0, 0, 0])
            )

    return fv_step


def make_fv_final(dtype, backend="cuda"):
    """Fused outer stage: both outer PPM fluxes (on the cross-advected
    fields) plus the two divergence updates in one stencil."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_final_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def fv_final(q: Field, qx: Field, qy: Field, cx: Field, cy: Field, qout: Field):
        with computation(PARALLEL), interval(...):
            # x flux on qy
            alx = 7.0 / 12.0 * (qy[-1, 0, 0] + qy[0, 0, 0]) - 1.0 / 12.0 * (
                qy[-2, 0, 0] + qy[1, 0, 0]
            )
            blx = alx[0, 0, 0] - qy[0, 0, 0]
            brx = alx[1, 0, 0] - qy[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (qy[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (qy[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            # y flux on qx
            aly = 7.0 / 12.0 * (qx[0, -1, 0] + qx[0, 0, 0]) - 1.0 / 12.0 * (
                qx[0, -2, 0] + qx[0, 1, 0]
            )
            bly = aly[0, 0, 0] - qx[0, 0, 0]
            bry = aly[0, 1, 0] - qx[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (qx[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (qx[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qout = (
                q[0, 0, 0]
                - (fx[1, 0, 0] - fx[0, 0, 0])
                - (fy[0, 1, 0] - fy[0, 0, 0])
            )

    return fv_final


def make_flux_update_x(dtype, backend="cuda", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_upd_x_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def update_x(q: Field, flux: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            qout = q[0, 0, 0] - FACTOR * (flux[1, 0, 0] - flux[0, 0, 0])

    return update_x


def make_flux_update_y(dtype, backend="cuda", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_upd_y_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def update_y(q: Field, flux: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            qout = q[0, 0, 0] - FACTOR * (flux[0, 1, 0] - flux[0, 0, 0])

    return update_y


class FvAdvection:
    """2D finite-volume transport: Lin-Rood split PPM advection.

    ``step(q, cx, cy) -> q_new`` on physical K-leading (K, NI+2h+p, NJ+2h+p)
    tensors on ``device`` with periodic boundaries; Courant numbers are
    face-centered (cx at face i, cy at face j).  A step is one stencil,
    ``fv_step``, with the periodic wrap in its loads.  ``options``: build
    options of ``fv_step`` (``serialize``, ``vector``, ``repair``).
    """

    HALO = 3

    def __init__(self, ni: int, nj: int, nk: int, *, dtype=np.float32,
                 backend="cuda", aligned: bool = True, device=None,
                 options: Optional[dict] = None):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        self.backend = backend
        self.device = config.resolve_device(device)
        h = self.HALO
        self.aligned = aligned
        self.oi = ORIGIN_I if aligned else h
        self.oj = ORIGIN_J if aligned else h
        kw = dict(origin=(self.oi, self.oj, 0), domain=(ni, nj, nk), physical_layout=True)
        kw_p = dict(kw, periodic=("I", "J"))

        self.xflux = make_xflux(dtype, backend)
        self.yflux = make_yflux(dtype, backend)
        self.upd_x_half = make_flux_update_x(dtype, backend, factor=0.5)
        self.upd_y_half = make_flux_update_y(dtype, backend, factor=0.5)
        self.upd_x = make_flux_update_x(dtype, backend, factor=1.0)
        self.upd_y = make_flux_update_y(dtype, backend, factor=1.0)
        self.fv_step = make_fv_step(dtype, backend, **(options or {}))
        self.fns = {
            # single-stencil step: qx/qy/fluxes as temporaries, periodic
            # wrap in the loads
            "step_p": self.fv_step.functional(**kw_p),
            # non-periodic step: halos pre-filled by the caller (HALO=3
            # covers the read extent exactly)
            "step": self.fv_step.functional(**kw),
        }

    def field_shape(self) -> Tuple[int, int, int]:
        if self.aligned:
            return aligned_field_shape(self.nk, self.ni, self.nj)
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The JAX model's numpy ``default_rng(seed)`` draw, on ``device``."""
        rng = np.random.default_rng(seed)
        shape = self.field_shape()
        q = rng.random(shape)
        cx = 0.4 * (rng.random(shape) - 0.5)
        cy = 0.4 * (rng.random(shape) - 0.5)
        return state_from_numpy({"q": q, "cx": cx, "cy": cy}, self.device, self.dtype)

    # ------------------------------------------------------------------ #

    def fill_winds(self, cx, cy):
        """Periodically fill the Courant fields' halos, in place."""
        h = self.HALO
        return (
            periodic_fill(cx, h, self.ni, self.nj, self.oi, self.oj),
            periodic_fill(cy, h, self.ni, self.nj, self.oi, self.oj),
        )

    def step_fn(self):
        """``step(q, cx, cy) -> q_new`` with periodic boundaries: the reads
        wrap in the stencil, so the step fills no halo.  The output buffer
        is a fresh ``torch.zeros_like(q)``, as in the JAX model."""
        fn = self.fns["step_p"]

        def step(q, cx, cy):
            return fn(q=q, cx=cx, cy=cy, qout=torch.zeros_like(q))["qout"]

        return step

    def local_step_fn(self):
        """Non-periodic step on halo-prefilled blocks (the halo-exchange
        path)."""
        fn = self.fns["step"]

        def step(q, cx, cy):
            return fn(q=q, cx=cx, cy=cy, qout=torch.zeros_like(q))["qout"]

        return step

    # ------------------------------------------------------------------ #

    def run_numpy_oracle(self, q, cx, cy):
        """The split step stage by stage, as the JAX model's oracle runs it:
        six stencils on logical (I, J, K) numpy arrays with tight halos,
        each output periodically filled before the next reads it.  Returns
        a numpy array."""
        h, ni, nj, nk = self.HALO, self.ni, self.nj, self.nk
        origin = (h, h, 0)
        dom = (ni, nj, nk)

        def fill(a):
            a[:h] = a[ni: ni + h]
            a[h + ni: 2 * h + ni] = a[h: 2 * h]
            a[:, :h] = a[:, nj: nj + h]
            a[:, h + nj: 2 * h + nj] = a[:, h: 2 * h]
            return a

        q = fill(np.array(q, copy=True))
        cx, cy = np.asarray(cx), np.asarray(cy)
        fx0, fy0, qx, qy = (np.zeros_like(q) for _ in range(4))
        self.xflux(q, cx, fx0, origin=origin, domain=dom)
        fill(fx0)
        self.upd_x_half(q, fx0, qx, origin=origin, domain=dom)
        self.yflux(q, cy, fy0, origin=origin, domain=dom)
        fill(fy0)
        self.upd_y_half(q, fy0, qy, origin=origin, domain=dom)
        fill(qx)
        fill(qy)
        fx, fy = np.zeros_like(q), np.zeros_like(q)
        self.xflux(qy, cx, fx, origin=origin, domain=dom)
        fill(fx)
        self.yflux(qx, cy, fy, origin=origin, domain=dom)
        fill(fy)
        q1, q2 = np.zeros_like(q), np.zeros_like(q)
        self.upd_x(q, fx, q1, origin=origin, domain=dom)
        fill(q1)
        self.upd_y(q1, fy, q2, origin=origin, domain=dom)
        return q2
