"""Combined dycore timestep: hdiff + vertical advection (MiniDycore), FVTP2D
tracer advection (FvAdvection) and semi-Lagrangian transport of a second
tracer -- counterpart of ``gt4py_tpu.models.full_dycore``, the BASELINE
"combined" workload, over physical K-leading tensors."""

from typing import Dict, Tuple

import numpy as np
import torch

from gt4py_tpu_torch import config

from .dycore import MiniDycore, state_from_numpy
from .fv_advection import FvAdvection
from .semi_lagrangian import make_sl_stencil

__all__ = ["FullDycore", "state_from_numpy"]


class FullDycore:
    """Prognostic u (diffused + vertically advected) plus a tracer q
    transported by FVTP2D and a second tracer qsl by semi-Lagrangian
    interpolation.  ``step_fn()`` returns ``step(state) -> state``; the input
    state is left unchanged."""

    HALO = 3

    def __init__(self, ni: int, nj: int, nk: int, *, dtype=np.float32,
                 backend="cuda", aligned: bool = True, device=None):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        self.device = config.resolve_device(device)
        self.dyn = MiniDycore(ni, nj, nk, dtype=dtype, backend=backend, aligned=aligned,
                              device=self.device)
        self.fv = FvAdvection(ni, nj, nk, dtype=dtype, backend=backend, aligned=aligned,
                              device=self.device)
        self.oi, self.oj = self.dyn.oi, self.dyn.oj
        assert self.dyn.field_shape() == self.fv.field_shape()
        # semi-Lagrangian transport as a stencil (windowed W=1, periodic
        # wrap in the loads); winds are Courant numbers <= 0.4 cells
        self.sl = make_sl_stencil(dtype, backend, max_shift=1)
        self.sl_fn = self.sl.functional(
            origin=(self.oi, self.oj, 0),
            domain=(ni, nj, nk),
            physical_layout=True,
            periodic=("I", "J"),
        )

    def field_shape(self) -> Tuple[int, int, int]:
        return self.dyn.field_shape()

    def init_state(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The JAX model's draw: MiniDycore from ``seed``, FvAdvection from
        ``seed + 1``, ``qsl`` from ``seed + 2``."""
        state = self.dyn.init_state(seed)
        fv_state = self.fv.init_state(seed + 1)
        state["q"] = fv_state["q"]
        state["cx"] = fv_state["cx"]
        state["cy"] = fv_state["cy"]
        rng = np.random.default_rng(seed + 2)
        qsl = rng.random(self.field_shape())
        state["qsl"] = state_from_numpy({"qsl": qsl}, self.device, self.dtype)["qsl"]
        return state

    def step_fn(self):
        """One combined step: the MiniDycore step, the FvAdvection step on
        ``q`` and the semi-Lagrangian stencil on ``qsl``.  The winds are
        u = cx/dt, so the displacement u*dt/dx is cx: the Courant fields go
        in directly with ``dtdx = dtdy = 1``."""
        dyn_step = self.dyn.step_fn()
        fv_step = self.fv.step_fn()
        sl_fn = self.sl_fn

        def step(state: Dict) -> Dict:
            state = dyn_step(state)
            q = fv_step(state["q"], state["cx"], state["cy"])
            qsl = sl_fn(q=state["qsl"], u=state["cx"], v=state["cy"],
                        qout=torch.zeros_like(state["qsl"]), dtdx=1.0, dtdy=1.0)["qout"]
            new = dict(state)
            new["q"] = q
            new["qsl"] = qsl
            return new

        return step
