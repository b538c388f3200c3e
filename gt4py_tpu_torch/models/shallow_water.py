"""Rotating shallow-water equations on an Arakawa C-grid.

Counterpart of ``gt4py_tpu.models.shallow_water``: the same GTScript
definition (linear multi-layer SWE, every K level an independent layer,
forward-backward time stepping: momentum with the current height gradient,
continuity with the updated winds), composed over torch tensors in the
physical (K, I, J) layout.  ``h`` lives at cell centres, ``u`` at x-faces
(index i is the face between cells i-1 and i), ``v`` at y-faces.  The
whole step is one stencil; the provisional winds are temporaries that the
continuity update reads at offsets, so on ``"cuda"`` the step is two
row-form stages.  Mass is conserved exactly under periodic boundaries
(flux form: the height update telescopes under the periodic sum).

The tight layout (``aligned=False``, halo 2) puts each row's interior at
J element 2 of a 516-element row: 2064 bytes, a whole number of 16-byte
words, so the row form's vector kernels run on it without a copy (one
common phase); the aligned layout is the JAX model's (8, 128).
"""

# NOTE: no ``from __future__ import annotations`` here -- stencil parameter
# annotations must evaluate eagerly (closure-local Field descriptors).

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

from .dycore import ORIGIN_I, ORIGIN_J, _literal_precision, aligned_field_shape, state_from_numpy


def make_sw_step(dtype, backend="cuda", *, g=9.81, H=100.0, f=1e-4,
                 dx=1e4, dy=1e4, dt=10.0, **options):
    """Forward-backward C-grid step: u, v advance with the old height
    gradient (and Coriolis on the 4-point averaged transverse wind), h
    with the divergence of the new winds (in-stencil temporaries).
    ``options``: the stencil's build options (``vector``, ``repair`` for
    ``"cuda"``)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"sw_step_{np.dtype(dtype).name}",
        externals={
            "G_DTDX": g * dt / dx,
            "G_DTDY": g * dt / dy,
            "H_DTDX": H * dt / dx,
            "H_DTDY": H * dt / dy,
            "F_DT": f * dt,
        },
        literal_precision=_literal_precision(dtype),
        **options,
    )
    def sw_step(
        h: Field,
        u: Field,
        v: Field,
        h_new: Field,
        u_new: Field,
        v_new: Field,
    ):
        from __externals__ import F_DT, G_DTDX, G_DTDY, H_DTDX, H_DTDY

        with computation(PARALLEL), interval(...):
            # transverse winds averaged to the opposite staggering points
            vbar = 0.25 * (v[-1, 0, 0] + v[0, 0, 0] + v[-1, 1, 0] + v[0, 1, 0])
            ubar = 0.25 * (u[0, -1, 0] + u[1, -1, 0] + u[0, 0, 0] + u[1, 0, 0])
            # provisional winds (temporaries: read at offsets below)
            ut = u[0, 0, 0] + F_DT * vbar - G_DTDX * (h[0, 0, 0] - h[-1, 0, 0])
            vt = v[0, 0, 0] - F_DT * ubar - G_DTDY * (h[0, 0, 0] - h[0, -1, 0])
            # continuity with the updated winds (forward-backward)
            h_new = (
                h[0, 0, 0]
                - H_DTDX * (ut[1, 0, 0] - ut[0, 0, 0])
                - H_DTDY * (vt[0, 1, 0] - vt[0, 0, 0])
            )
            u_new = ut[0, 0, 0]
            v_new = vt[0, 0, 0]

    return sw_step


class ShallowWater:
    """Multi-layer linear rotating SWE, one stencil a step.

    ``step_fn()`` and ``local_step_fn()`` return ``step(h, u, v) -> (h, u,
    v)`` on physical (K, I, J) tensors on ``device``; the inputs are left
    unchanged.  ``options``: build options of the stencil.
    """

    HALO = 2

    def __init__(self, ni: int, nj: int, nk: int, *, dtype=np.float32, backend="cuda",
                 aligned: bool = True, device=None, options: Optional[dict] = None,
                 g=9.81, H=100.0, f=1e-4, dx=1e4, dy=1e4, dt=10.0):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        self.backend = backend
        self.device = config.resolve_device(device)
        self.params = dict(g=g, H=H, f=f, dx=dx, dy=dy, dt=dt)
        h = self.HALO
        self.aligned = aligned
        self.oi = ORIGIN_I if aligned else h
        self.oj = ORIGIN_J if aligned else h
        self.stencil = make_sw_step(dtype, backend, **self.params, **(options or {}))
        kw = dict(origin=(self.oi, self.oj, 0), domain=(ni, nj, nk), physical_layout=True)
        self.fn = self.stencil.functional(**kw)
        self.fn_p = self.stencil.functional(**kw, periodic=("I", "J"))

    def field_shape(self) -> Tuple[int, int, int]:
        if self.aligned:
            return aligned_field_shape(self.nk, self.ni, self.nj)
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """A Gaussian height anomaly per layer, winds at rest: the JAX
        model's numpy state (``seed`` unused, as there), on ``device``."""
        shape = self.field_shape()
        _, pni, pnj = shape
        ii = np.arange(pni)[None, :, None] - self.oi
        jj = np.arange(pnj)[None, None, :] - self.oj
        ci, cj = self.ni / 2, self.nj / 2
        r2 = ((ii - ci) / (self.ni / 8)) ** 2 + ((jj - cj) / (self.nj / 8)) ** 2
        bump = np.exp(-r2)
        amp = 1.0 + 0.1 * np.arange(1, self.nk + 1)[:, None, None] / self.nk
        state = {
            "h": (amp * bump).astype(self.dtype),
            "u": np.zeros(shape, self.dtype),
            "v": np.zeros(shape, self.dtype),
        }
        return state_from_numpy(state, self.device)

    # ------------------------------------------------------------------ #

    def _step(self, fn):
        def step(h, u, v):
            z = torch.zeros_like(h)
            outs = fn(h=h, u=u, v=v, h_new=z, u_new=z, v_new=z)
            return outs["h_new"], outs["u_new"], outs["v_new"]

        return step

    def step_fn(self):
        """Periodic boundaries, folded into the kernels' loads (no fill
        passes)."""
        return self._step(self.fn_p)

    def local_step_fn(self):
        """Non-periodic step on halo-prefilled blocks (the halo-exchange
        path)."""
        return self._step(self.fn)

    # ------------------------------------------------------------------ #

    def run_plain_oracle(self, h, u, v):
        """The JAX model's ``run_numpy_oracle`` on the plain executor: on
        logical (I, J, K) tensors with halo 2, fill the halos periodically
        and run the step's stencil on ``backend="torch"``.  Returns the new
        (h, u, v)."""
        hw, ni, nj, nk = self.HALO, self.ni, self.nj, self.nk
        plain = make_sw_step(self.dtype, "torch", **self.params)

        def fill(a):
            a[:hw] = a[ni: ni + hw].clone()
            a[hw + ni: 2 * hw + ni] = a[hw: 2 * hw].clone()
            a[:, :hw] = a[:, nj: nj + hw].clone()
            a[:, hw + nj: 2 * hw + nj] = a[:, hw: 2 * hw].clone()
            return a

        h, u, v = fill(h.clone()), fill(u.clone()), fill(v.clone())
        hn, un, vn = torch.zeros_like(h), torch.zeros_like(u), torch.zeros_like(v)
        plain(h, u, v, hn, un, vn, origin=(hw, hw, 0), domain=(ni, nj, nk))
        return hn, un, vn
