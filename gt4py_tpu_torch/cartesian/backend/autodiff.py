"""K8: derivatives through the generated kernels.

The counterpart of ``PallasBackend._trace_env``
(``gt4py_tpu/cartesian/backend/pallas_backend.py:178``), which wraps every
kernel call in a ``jax.custom_jvp``: the primal from the kernel, the
tangent from the package's own executor, transposed by ``jax.grad``.  Here
one ``torch.autograd.Function`` does the same around a kernel launch:

- forward: the written buffers are cloned and the kernels run on the
  clones (the launch is a callable, ``CudaBackend._launch`` on the card);
- backward: the adjoint stencil (``cartesian/derivative.py``: the
  forward's IR reversed in gather form, built by the ``"cuda"`` backend)
  runs on the inputs from before the call and the outputs' cotangents and
  writes the input gradients -- the kernels on the card; a tensor
  scalar's gradient is the sum of its per-point contribution field.
  Under a ``torch.func`` transform (``grad``, ``vjp``) the same kernels run
  on the tensors under its wrappers;
- jvp: the tangent stencil (the forward's loops with a tangent statement
  before each assignment) on the inputs and their tangents, under
  ``torch.func.jvp`` and ``torch.autograd.forward_ad`` alike.

The derivative stencils run when the call's tensors are on the card
(``derivative=None``, the default), or on any device with
``derivative="kernels"`` (on the CPU the plain executor runs them).
Otherwise -- CPU tensors by default, or a
stencil with a construct that has no gather-form adjoint
(``derivative.PLAIN_RERUN``: ``while``, variable- or absolute-K and dynamic
data-index reads of a field whose gradient is wanted, ``gamma``; each
recorded in ``LAST_PLAN[name]["adjoint"]`` / ``["tangent"]``) -- the plain
executor re-runs (``torch_backend.run_plain``) on detached inputs under
``torch.enable_grad()``: ``torch.autograd.grad`` of that re-run gives the
gradients (``torch.func.vjp`` of it under a ``torch.func`` transform), and
forward-mode duals of the inputs the tangents.  The transform's other
declines (``derivative.Declined.reruns`` false: work still open) raise on
the card, a forced ``derivative="kernels"`` raises every decline, and a
derivative kernel that fails to build or launch raises like the forward's.

The inputs are every field of the call (the written ones as their buffers
before the call: halos are kept and values are read before they are
written) and the tensor scalars; Python-number scalars are constants.  A
call engages this only when a derivative is wanted
(``torch_backend.wants_derivative``); otherwise the kernels run as they do
for serving, with no extra copy.  Tests: ``tests/test_torch_derivative.py``
(the derivative stencils on the plain executor and on the emulated kernels
against the JAX package), ``chip_smoke.py`` phase 9 on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD
from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter

from gt4py_tpu_torch.cartesian import derivative
from gt4py_tpu_torch.cartesian.backend.torch_backend import (
    TorchExecutor,
    has_horizontal_reads,
    is_functorch_wrapped_tensor,
    periodic_fill,
    run_plain,
)


@dataclasses.dataclass
class _Call:
    """What a call is besides its tensors: the launch, the plain executor,
    the field names in input order, the written ones, the tensor scalars'
    names, the other scalars, the domain, origins and periodic axes."""

    launch: Callable
    plain: TorchExecutor
    names: List[str]
    written: List[str]
    tensor_scalars: List[str]
    scalars: Dict[str, Any]
    domain: Tuple[int, int, int]
    origins: Dict[str, Tuple[int, int, int]]
    periodic: Tuple[str, ...]
    #: the derivative stencils' source (``CudaBackend``), or None
    kernels: Any = None

    def bind(self, tensors: Sequence[torch.Tensor]):
        """The call's env (written fields as clones, which the call fills)
        and scalars from the Function's inputs."""
        n = len(self.names)
        written = set(self.written)
        env = {name: (t.clone() if name in written else t)
               for name, t in zip(self.names, tensors[:n])}
        return env, {**self.scalars, **dict(zip(self.tensor_scalars, tensors[n:]))}

    def run_plain(self, tensors) -> List[torch.Tensor]:
        env, scalars = self.bind(tensors)
        run_plain(self.plain, env, scalars, self.domain, self.origins, self.periodic)
        return [env[name] for name in self.written]


class _KernelCall(torch.autograd.Function):
    """Inputs: the ``_Call``, then the fields in ``names`` order, then the
    tensor scalars.  Outputs: the written fields' new buffers."""

    @staticmethod
    def forward(call: _Call, *tensors):
        env, scalars = call.bind(tensors)
        call.launch(env, scalars, call.domain, call.origins, call.periodic)
        return tuple(env[name] for name in call.written)

    @staticmethod
    def setup_context(ctx, inputs, output):
        call, tensors = inputs[0], inputs[1:]
        ctx.call = call
        # an output the loss does not use brings None, not a zero tensor
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*tensors)
        if any(ctx.needs_input_grad):
            # the written fields' new tensors go back to the caller and their
            # buffers keep the values from before the call, which the
            # backward reads
            ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        needs = ctx.needs_input_grad[1:]
        saved = ctx.saved_tensors
        if _on_kernels(call, saved):
            got = _adjoint_kernels(call, saved, needs, grads)
            if got is not None:
                return (None,) + got
        if call.kernels is not None:
            call.kernels.plain_reruns += 1
        if any(is_functorch_wrapped_tensor(t) for t in saved):
            return (None,) + _functorch_backward(call, saved, needs, grads)
        with torch.enable_grad():
            # only the inputs whose gradient is wanted are leaves that require
            # it, so autograd prunes the rest of the re-run's graph
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            outs = call.run_plain(leaves)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
            wrt = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                      allow_unused=True) if pairs else [None] * len(wrt)
        it = iter(got)
        return (None,) + tuple(next(it) if t.requires_grad else None for t in leaves)

    @staticmethod
    def jvp(ctx, _, *tangents):
        call = ctx.call
        if _on_kernels(call, ctx.saved_tensors):
            got = _tangent_kernels(call, ctx.saved_tensors, tangents)
            if got is not None:
                return got
        if call.kernels is not None:
            call.kernels.plain_reruns += 1
        with fwAD._set_fwd_grad_enabled(True):
            duals = [fwAD.make_dual(p.detach(), t) if t is not None and p.is_floating_point()
                     else p.detach() for p, t in zip(ctx.saved_tensors, tangents)]
            outs = call.run_plain(duals)
            tans = [fwAD.unpack_dual(o).tangent for o in outs]
        return tuple(torch.zeros_like(o) if t is None else t.clone() for o, t in zip(outs, tans))


def _functorch_backward(call: _Call, saved, needs, grads) -> tuple:
    """The backward under a ``torch.func`` transform: ``torch.func.vjp`` of
    the plain re-run with respect to the inputs whose gradient is wanted."""
    wanted = [i for i, need in enumerate(needs) if need]
    outs = [n for n, g in enumerate(grads) if g is not None]

    def rerun(*wrt):
        tensors = list(saved)
        for i, t in zip(wanted, wrt):
            tensors[i] = t
        new = call.run_plain(tensors)
        return tuple(new[n] for n in outs)

    _, pull = torch.func.vjp(rerun, *[saved[i] for i in wanted])
    got = dict(zip(wanted, pull(tuple(grads[n] for n in outs))))
    return tuple(got.get(i) for i in range(len(saved)))


@contextlib.contextmanager
def _below_the_transform():
    """The derivative stencils run below the ``torch.func`` transform whose
    backward or jvp calls them: its wrappers come off the call's tensors
    (the yielded ``peel``) and tensors made meanwhile carry none, so under
    one transform the kernels see plain tensors.  An outer transform's
    wrappers stay: it differentiates the derivative stencils in turn, each
    through its own K8 call (a derivative stencil of the derivative
    stencil), as it does under ``create_graph=True``."""
    if torch._C._functorch.peek_interpreter_stack() is None:
        yield lambda t: t
        return
    interp = retrieve_current_functorch_interpreter()
    level = interp.level()

    def peel(t):
        if isinstance(t, torch.Tensor) and is_functorch_wrapped_tensor(t) and \
                torch._C._functorch.maybe_get_level(t) == level:
            return torch._C._functorch.get_unwrapped(t)
        return t

    with interp.lower():
        yield peel


def _on_kernels(call: _Call, tensors) -> bool:
    """Whether the derivative runs as derivative stencils: with
    ``derivative="kernels"`` always, by default when the call's tensors are
    on the card."""
    if call.kernels is None:
        return False
    if call.kernels.derivative_opt == "kernels":
        return True
    return any(t.device.type == "cuda" for t in tensors if isinstance(t, torch.Tensor))


def _padded(view: torch.Tensor, origin, reach, domain, skip=()):
    """``view`` and its origin, copied into a zero buffer wide enough for
    reads ``reach`` beyond the domain where it is not (axes in ``skip``
    wrap, and axes the field lacks are left alone)."""
    pads = []
    for ax in range(3):
        if view.shape[ax] == 1 and domain[ax] != 1 or "IJK"[ax] in skip:
            pads.append((0, 0))
            continue
        lo = max(0, reach[ax][0] - origin[ax])
        hi = max(0, origin[ax] + domain[ax] + reach[ax][1] - view.shape[ax])
        pads.append((lo, hi))
    if not any(lo or hi for lo, hi in pads):
        return view, origin
    shape = [n + lo + hi for n, (lo, hi) in zip(view.shape[:3], pads)] + list(view.shape[3:])
    big = torch.zeros(shape, dtype=view.dtype, device=view.device)
    big[pads[0][0]: pads[0][0] + view.shape[0], pads[1][0]: pads[1][0] + view.shape[1],
        pads[2][0]: pads[2][0] + view.shape[2]] = view
    return big, tuple(o + lo for o, (lo, _) in zip(origin, pads))


def _fold(g: torch.Tensor, origin, domain, ext, axes) -> None:
    """The transpose of ``torch_backend.periodic_fill`` on a gradient, in
    place: each halo strip the fill copied from the inside (J over every I
    row after I) adds into that inside and is zeroed, in reverse order."""
    for ax in ("J", "I"):
        if ax not in axes:
            continue
        a = 1 if ax == "J" else 0
        if g.shape[a] == 1:
            continue
        o, d = origin[a], domain[a]
        lo, hi = -(ext.j if a else ext.i)[0], (ext.j if a else ext.i)[1]
        v = g if a == 0 else g.transpose(0, 1)
        if hi:
            v[o: o + hi] += v[o + d: o + d + hi]
            v[o + d: o + d + hi] = 0
        if lo:
            v[o + d - lo: o + d] += v[o - lo: o]
            v[o - lo: o] = 0


def _declined(call: _Call, e: derivative.Declined) -> None:
    """Raise ``e`` unless the plain re-run may take the derivative: it may
    only for the constructs of ``derivative.PLAIN_RERUN``, and never with a
    forced ``derivative="kernels"``."""
    if call.kernels.derivative_opt == "kernels" or not e.reruns:
        raise e


def _adjoint_kernels(call: _Call, saved, needs, grads):
    """The input gradients from the adjoint stencil (None: it declines with
    a reason of ``derivative.PLAIN_RERUN`` and the plain re-run gives them;
    any other decline, and every decline under a forced
    ``derivative="kernels"``, raises)."""
    n = len(call.names)
    wanted = tuple([nm for nm, need in zip(call.names, needs[:n]) if need] +
                   [nm for nm, need in zip(call.tensor_scalars, needs[n:]) if need])
    try:
        d, backend = call.kernels.derivative("adjoint", wanted, call.domain[2], call.periodic)
    except derivative.Declined as e:
        _declined(call, e)
        return None
    with _below_the_transform() as peel:
        return _run_adjoint(call, d, backend, [peel(t) for t in saved], needs,
                            [peel(g) for g in grads])


def _run_adjoint(call: _Call, d, backend, saved, needs, grads) -> tuple:
    n = len(call.names)
    # the adjoint runs on the call's levels grown by the wanted fields' K
    # halos: every origin that much lower
    kl, kh = d.k_grow
    dom = (call.domain[0], call.domain[1], call.domain[2] + kl + kh)
    at = {nm: (o[0], o[1], o[2] - kl) for nm, o in call.origins.items()}
    env = dict(zip(call.names, saved[:n]))
    origins = {nm: at[nm] for nm in call.names}
    cot = {}
    for nm, g in zip(call.written, grads):
        if nm in d.cots:
            # in the field's own layout (the kernels read J rows)
            cot[nm] = torch.zeros_like(env[nm]) if g is None else g \
                if g.stride() == env[nm].stride() else torch.empty_like(env[nm]).copy_(g)
            env[d.cots[nm]], origins[d.cots[nm]] = cot[nm], at[nm]
    for nm, g in d.grads.items():
        env[g] = cot[nm].clone() if nm in d.passthrough else torch.zeros_like(env[nm])
        origins[g] = at[nm]
    scalars = dict(call.scalars)
    scalars.update(zip(call.tensor_scalars, saved[n:]))
    for nm, c in d.contribs.items():
        e = d.contrib_extent[nm]
        shape = (dom[0] - e.i[0] + e.i[1], dom[1] - e.j[0] + e.j[1], dom[2])
        env[c] = torch.zeros(shape, dtype=scalars[nm].dtype, device=saved[0].device)
        origins[c] = (-e.i[0], -e.j[0], 0)
    fwd = call.plain.analysis
    filled = [nm for nm in call.names if d.fill and has_horizontal_reads(fwd, nm)]
    if filled:
        # the forward's fill, on copies: the adjoint then runs bounded
        copies = {nm: env[nm].clone() for nm in filled}
        periodic_fill(fwd, copies, call.domain, at, d.fill, filled)
        env.update(copies)
    periodic = () if d.fill else call.periodic
    kernels = saved[0].device.type == "cuda"
    for nm, reach in d.reach.items():
        if nm in env:
            env[nm], origins[nm] = _padded(env[nm], origins[nm], reach, dom,
                                           periodic if kernels else ())
    got: Dict[str, torch.Tensor] = {}
    backend.apply(env, scalars, dom, origins, periodic, outputs=got)
    env.update(got)
    for nm in filled:
        if nm in d.grads:
            _fold(env[d.grads[nm]], origins[d.grads[nm]], dom, fwd.extents.field_extent(nm),
                  d.fill)
    call.kernels.adjoint_calls += 1
    out = []
    for i, need in enumerate(needs):
        if not need:
            out.append(None)
        elif i < n:
            out.append(env[d.grads[call.names[i]]])
        else:
            nm = call.tensor_scalars[i - n]
            out.append(env[d.contribs[nm]].sum().to(scalars[nm].dtype).reshape(
                scalars[nm].shape))
    return tuple(out)


def _tangent_kernels(call: _Call, saved, tangents):
    """The written fields' tangents from the tangent stencil (None: it
    declines, as ``_adjoint_kernels``)."""
    n = len(call.names)
    keys = call.names + call.tensor_scalars
    tans = dict(zip(keys, tangents))
    wanted = tuple(nm for nm, t in zip(keys, saved)
                   if tans[nm] is not None and t.is_floating_point())
    try:
        d, backend = call.kernels.derivative("tangent", wanted)
    except derivative.Declined as e:
        _declined(call, e)
        return None
    with _below_the_transform() as peel:
        return _run_tangent(call, d, backend, [peel(t) for t in saved],
                            {nm: peel(t) for nm, t in tans.items()})


def _run_tangent(call: _Call, d, backend, saved, tans) -> tuple:
    n = len(call.names)
    written = set(call.written)
    env = {nm: (t.clone() if nm in written else t) for nm, t in zip(call.names, saved[:n])}
    origins = {nm: call.origins[nm] for nm in call.names}
    for nm in call.names:
        dot = d.dots.get(nm)
        if dot is None:
            continue
        t = tans[nm] if tans[nm] is not None else None
        env[dot] = (t.clone() if nm in written else t) if t is not None else \
            torch.zeros_like(env[nm])
        origins[dot] = call.origins[nm]
    scalars = dict(call.scalars)
    scalars.update(zip(call.tensor_scalars, saved[n:]))
    for nm in call.tensor_scalars:
        if nm in d.dots:
            scalars[d.dots[nm]] = tans[nm] if tans[nm] is not None else 0.0
    got: Dict[str, torch.Tensor] = {}
    backend.apply(env, scalars, call.domain, origins, call.periodic, outputs=got)
    env.update(got)
    call.kernels.tangent_calls += 1
    return tuple(env[d.dots[nm]] if nm in d.dots else
                 torch.zeros_like(env[nm]) if env[nm].is_floating_point() else None
                 for nm in call.written)


def kernel_call(launch: Callable, plain: TorchExecutor, written: Sequence[str],
                env: Dict[str, torch.Tensor], scalars: Dict[str, Any], domain, origins,
                periodic, outputs: dict, kernels=None) -> None:
    """Run ``launch(env, scalars, domain, origins, periodic)`` -- which
    fills the written fields of ``env`` in place -- as a differentiable
    operation on clones of the written fields: their new tensors go into
    ``outputs`` and ``env`` stays as it was.  ``kernels``: the backend
    whose derivative stencils the backward and jvp may run."""
    names = list(env)
    tensor_scalars = [n for n, v in scalars.items() if isinstance(v, torch.Tensor)]
    call = _Call(launch, plain, names, [n for n in names if n in written], tensor_scalars,
                 {n: v for n, v in scalars.items() if n not in tensor_scalars},
                 tuple(domain), dict(origins), tuple(periodic), kernels)
    outs = _KernelCall.apply(call, *[env[n] for n in names],
                             *[scalars[n] for n in tensor_scalars])
    outputs.update(zip(call.written, outs))
