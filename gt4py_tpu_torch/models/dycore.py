"""Mini dynamical core: horizontal diffusion + vertical advection.

Counterpart of ``gt4py_tpu.models.dycore``: the same four stencil
definitions (reference: tests/cartesian_tests/integration_tests/
multi_feature_tests/stencil_definitions.py:317-330 horizontal_diffusion and
:236-315 vertical_advection_dycore), composed functionally over torch
tensors in the physical (K, I, J) layout with J contiguous, so buffers trade
with the JAX model without transposes.  With ``backend="cuda"`` each stencil
runs as generated CUDA kernels on CUDA tensors.
"""

# NOTE: no ``from __future__ import annotations`` here -- stencil parameter
# annotations must evaluate eagerly so closure-local Field descriptors
# (``Field = gtscript.Field[dtype]`` inside factory functions) resolve.

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)
from gt4py_tpu_torch.core import dtypes


def _literal_precision(dtype) -> int:
    return 32 if np.dtype(dtype).itemsize <= 4 else 64


def make_hdiff(dtype, backend="cuda", **options):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"hdiff_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def horizontal_diffusion(in_field: Field, out_field: Field, coeff: Field):
        with computation(PARALLEL), interval(...):
            lap_field = 4.0 * in_field[0, 0, 0] - (
                in_field[1, 0, 0] + in_field[-1, 0, 0]
                + in_field[0, 1, 0] + in_field[0, -1, 0]
            )
            res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
            flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
            res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
            fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
            out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
                flx_field[0, 0, 0] - flx_field[-1, 0, 0]
                + fly_field[0, 0, 0] - fly_field[0, -1, 0]
            )

    return horizontal_diffusion


def make_vadv(dtype, backend="cuda", *, bet_m=0.5, bet_p=0.5, **options):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"vadv_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def vertical_advection_dycore(
        utens_stage: Field,
        u_stage: Field,
        wcon: Field,
        u_pos: Field,
        utens: Field,
        *,
        dtr_stage: dtype,  # stencil-precision scalar: a bare ``float``
        # annotation would make it f64 and C-promote the whole
        # tridiagonal temp chain to f64
    ):
        from __externals__ import BET_M, BET_P

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                    u_stage[0, 0, 1] - u_stage[0, 0, 0]
                )
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

    return vertical_advection_dycore


def make_vadv_update(dtype, backend="cuda", *, bet_m=0.5, bet_p=0.5, **options):
    """vadv fused with the prognostic update ``u_out = u_pos + ts/dtr``:
    one extra in-kernel write replaces a whole-buffer pass.  ``options``:
    build options of the stencil (``k_blocked`` for ``"cuda"``)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"vadv_upd_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def vertical_advection_update(
        utens_stage: Field,
        u_stage: Field,
        wcon: Field,
        u_pos: Field,
        utens: Field,
        u_out: Field,
        *,
        dtr_stage: dtype,
    ):
        from __externals__ import BET_M, BET_P

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                    u_stage[0, 0, 1] - u_stage[0, 0, 0]
                )
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
                u_out = u_pos[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
                u_out = u_pos[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)

    return vertical_advection_update


def make_dycore_fused(dtype, backend="cuda", *, bet_m=0.5, bet_p=0.5, **options):
    """The WHOLE dycore step as ONE stencil: horizontal diffusion
    (PARALLEL) feeding the vertical-advection tridiagonal solve
    (FORWARD+BACKWARD) and the prognostic update -- the diffused stage
    becomes an in-kernel TEMPORARY instead of an HBM round trip, and
    ``u`` is read once instead of twice.  On ``"cuda"`` it runs split by
    default (the tile kernel, then the fused column kernel:
    ``cuda_backend.SERIALIZE_MIXED``); ``options`` ``serialize=True`` run
    the PARALLEL loop serialized in the plane-sweep form (K5), and
    ``sweep=True`` sweep it with the serial loops in one kernel."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"dycore_fused_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def dycore_fused(
        u: Field,
        coeff: Field,
        wcon: Field,
        utens: Field,
        utens_stage: Field,
        u_out: Field,
        *,
        dtr_stage: dtype,
    ):
        from __externals__ import BET_M, BET_P

        with computation(PARALLEL), interval(...):
            lap_field = 4.0 * u[0, 0, 0] - (
                u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]
            )
            res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
            flx_field = 0 if (res * (u[1, 0, 0] - u[0, 0, 0])) > 0 else res
            res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
            fly_field = 0 if (res * (u[0, 1, 0] - u[0, 0, 0])) > 0 else res
            u_stage = u[0, 0, 0] - coeff[0, 0, 0] * (
                flx_field[0, 0, 0] - flx_field[-1, 0, 0]
                + fly_field[0, 0, 0] - fly_field[0, -1, 0]
            )

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (
                    u_stage[0, 0, -1] - u_stage[0, 0, 0]
                ) - cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_stage[0, 0, 0])
                u_out = u_stage[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_stage[0, 0, 0])
                u_out = u_stage[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)

    return dycore_fused


def periodic_fill(arr: torch.Tensor, h: int, ni: int, nj: int, oi: int = None,
                  oj: int = None) -> torch.Tensor:
    """Fill I/J halos (width h) of a physical (K, I, J) tensor periodically,
    in place (I first, then J, so corners wrap on both axes).  ``ni``/``nj``
    are the DOMAIN sizes; ``oi``/``oj`` the interior origins (default: the
    halo width ``h``).  Returns ``arr``."""
    if h == 0:
        return arr
    oi = h if oi is None else oi
    oj = h if oj is None else oj
    arr[:, oi - h: oi] = arr[:, oi + ni - h: oi + ni].clone()
    arr[:, oi + ni: oi + ni + h] = arr[:, oi: oi + h].clone()
    arr[:, :, oj - h: oj] = arr[:, :, oj + nj - h: oj + nj].clone()
    arr[:, :, oj + nj: oj + nj + h] = arr[:, :, oj: oj + h].clone()
    return arr


#: interior origins of the aligned layout, the JAX model's DMA-aligned
#: (8, 128): kept so both packages use the same buffers (on the GPU a J
#: origin of 128 floats puts every row's interior on a 512-byte boundary)
ORIGIN_I = 8
ORIGIN_J = 128


def aligned_field_shape(nk: int, ni: int, nj: int) -> Tuple[int, int, int]:
    """Physical (K, I, J) buffer shape with interior at (ORIGIN_I, ORIGIN_J)
    and the J extent a multiple of 128 (the JAX model's layout)."""
    si = ORIGIN_I + ni + ORIGIN_I + 8
    sj = ORIGIN_J + (-(-(nj + ORIGIN_J) // 128) * 128)
    return (nk, si, sj)


def state_from_numpy(state: Dict[str, np.ndarray], device=None,
                     dtype=None) -> Dict[str, torch.Tensor]:
    """Carry a JAX-model state (numpy arrays, physical (K, I, J)) into the
    port unchanged: same layout, dtype and values, on ``device``; or, with
    ``dtype``, converted to it as numpy converts (``core.dtypes.cast``:
    the way in for bfloat16, which numpy lacks)."""
    dev = config.resolve_device(device)
    out = {}
    for k, v in state.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t if dtype is None else dtypes.cast(t, dtype)).to(dev)
    return out


class MiniDycore:
    """A mini timestep: periodic-halo hdiff + vertical advection + update.

    ``step_fn()`` returns ``step(state) -> state`` over a dict of
    halo-extended physical (K, I, J) tensors on ``device``; the input state
    is left unchanged.  With ``fill_halos=False`` halos are assumed
    pre-filled (no periodic wrap).  ``options``: build options of every
    stencil (``serialize``, ``k_blocked`` for ``"cuda"``).
    """

    HALO = 3

    def __init__(self, ni: int, nj: int, nk: int, *, dtype=np.float32,
                 backend="cuda", aligned: bool = True, device=None,
                 options: Optional[dict] = None):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        self.device = config.resolve_device(device)
        h = self.HALO
        #: aligned=True places interiors at the (8, 128) origin;
        #: aligned=False packs tight at origin (h, h)
        self.aligned = aligned
        self.oi = ORIGIN_I if aligned else h
        self.oj = ORIGIN_J if aligned else h
        options = options or {}
        self.hdiff = make_hdiff(dtype, backend, **options)
        self.vadv = make_vadv(dtype, backend, **options)
        self.vadv_upd = make_vadv_update(dtype, backend, **options)
        self.fused = make_dycore_fused(dtype, backend, **options)
        kw = dict(origin=(self.oi, self.oj, 0), domain=(ni, nj, nk), physical_layout=True)
        self.hdiff_fn = self.hdiff.functional(**kw)
        self.vadv_fn = self.vadv.functional(**kw)
        self.vadv_upd_fn = self.vadv_upd.functional(**kw)
        self.fused_fn = self.fused.functional(**kw)
        # periodic variants: the wrap is folded into the kernels' loads
        self.hdiff_fn_p = self.hdiff.functional(**kw, periodic=("I", "J"))
        self.vadv_upd_fn_p = self.vadv_upd.functional(**kw, periodic=("I", "J"))
        self.fused_fn_p = self.fused.functional(**kw, periodic=("I", "J"))

    def field_shape(self) -> Tuple[int, int, int]:
        """Physical (K, I, J) buffer shape (see aligned_field_shape)."""
        if self.aligned:
            return aligned_field_shape(self.nk, self.ni, self.nj)
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The JAX model's numpy ``default_rng(seed)`` draw, on ``device``."""
        rng = np.random.default_rng(seed)
        shape = self.field_shape()
        state = {
            "u": rng.random(shape),
            "coeff": 0.025 * rng.random(shape),
            "wcon": 0.2 * rng.random(shape),
            "utens": 0.01 * rng.random(shape),
            "utens_stage": rng.random(shape),
        }
        return state_from_numpy(state, self.device, self.dtype)

    #: fields read at horizontal offsets (hdiff in_field at +-2, vadv wcon
    #: at i+1) -- the only ones whose halos a step needs
    FILL_FIELDS = ("u", "wcon")

    def step_fn(self, *, fill_halos: bool = True, dtr_stage: float = 3.0,
                fused: bool = False):
        """``fill_halos=True``: periodic boundaries (reads wrap in the
        kernels' loads, no fill passes).  ``fill_halos=False``: halos
        assumed pre-filled.  ``fused=True``: the whole step as one stencil
        (make_dycore_fused)."""
        if fused:
            fn = self.fused_fn_p if fill_halos else self.fused_fn

            def step(state: Dict) -> Dict:
                outs = fn(
                    u=state["u"],
                    coeff=state["coeff"],
                    wcon=state["wcon"],
                    utens=state["utens"],
                    utens_stage=state["utens_stage"],
                    u_out=state["u"],
                    dtr_stage=dtr_stage,
                )
                new_state = dict(state)
                new_state["u"] = outs["u_out"]
                new_state["utens_stage"] = outs["utens_stage"]
                return new_state

            return step
        hdiff_fn = self.hdiff_fn_p if fill_halos else self.hdiff_fn
        vadv_upd_fn = self.vadv_upd_fn_p if fill_halos else self.vadv_upd_fn
        return self._make_step(hdiff_fn, vadv_upd_fn, dtr_stage)

    def region_step_factory(self, *, dtr_stage: float = 3.0):
        """``make((oi, oj), (di, dj)) -> step(**fields) -> dict`` computing
        only the given sub-region (halo-extended local coordinates): the
        region interface ``overlapped_shard_map_stencil`` splits a rank's
        step into a halo-independent interior and halo-dependent boundary
        strips.  vadv reads its chained input ``u_stage`` only at K
        offsets, so the hdiff/vadv regions coincide exactly."""

        def make(origin_ij, domain_ij):
            oi, oj = origin_ij
            di, dj = domain_ij
            kw = dict(origin=(oi, oj, 0), domain=(di, dj, self.nk), physical_layout=True)
            step = self._make_step(self.hdiff.functional(**kw),
                                   self.vadv_upd.functional(**kw), dtr_stage)

            def region_step(**fields):
                return step(dict(fields))

            return region_step

        return make

    def _make_step(self, hdiff_fn, vadv_upd_fn, dtr_stage: float):

        def step(state: Dict) -> Dict:
            u = state["u"]
            # in_field and out_field name one buffer: the write goes to a
            # fresh output (a clone of u), so no kernel reads what it writes
            diffused = hdiff_fn(in_field=u, out_field=u, coeff=state["coeff"])["out_field"]
            outs = vadv_upd_fn(
                utens_stage=state["utens_stage"],
                u_stage=diffused,
                wcon=state["wcon"],
                u_pos=diffused,
                utens=state["utens"],
                u_out=u,
                dtr_stage=dtr_stage,
            )
            new_state = dict(state)
            new_state["u"] = outs["u_out"]
            new_state["utens_stage"] = outs["utens_stage"]
            return new_state

        return step
