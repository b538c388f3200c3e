"""K8: derivatives through the generated kernels.

The counterpart of ``PallasBackend._trace_env``
(``gt4py_tpu/cartesian/backend/pallas_backend.py:178``), which wraps every
kernel call in a ``jax.custom_jvp``: the primal from the kernel, the
tangent from the package's own executor.  Here one
``torch.autograd.Function`` does the same around a kernel launch:

- forward: the written buffers are cloned and the kernels run on the
  clones (the launch is a callable, ``CudaBackend._launch`` on the card);
- backward: the plain executor (``torch_backend.run_plain``) re-runs on
  detached inputs under ``torch.enable_grad()``, and ``torch.autograd.grad``
  of that re-run gives the input gradients; under a ``torch.func``
  transform (``grad``, ``vjp``), whose tensors cannot be made leaves, the
  re-run's ``torch.func.vjp`` gives them;
- jvp: the same re-run on forward-mode duals of the inputs at the caller's
  level (``torch.func.jvp`` cannot be nested inside a
  ``torch.autograd.forward_ad`` level; duals work under both).

The inputs are every field of the call (the written ones as their buffers
before the call: halos are kept and values are read before they are
written) and the tensor scalars; Python-number scalars are constants.  A
call engages this only when a derivative is wanted
(``torch_backend.wants_derivative``); otherwise the kernels run as they do
for serving, with no extra copy.  Bound: the backward's time is the plain
executor's (its bytes are the inputs, cotangents and input gradients);
a backward made of kernels is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from gt4py_tpu_torch.cartesian.backend.torch_backend import (
    TorchExecutor,
    is_functorch_wrapped_tensor,
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
        ctx.save_for_forward(*tensors)
        if any(ctx.needs_input_grad):
            # the written buffers are overwritten once the call returns: the
            # backward's re-run needs their values from before it
            written = set(call.written)
            ctx.save_for_backward(*[
                t.detach().clone() if i < len(call.names) and call.names[i] in written else t
                for i, t in enumerate(tensors)])

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        needs = ctx.needs_input_grad[1:]
        saved = ctx.saved_tensors
        if any(is_functorch_wrapped_tensor(t) for t in saved):
            return (None,) + _functorch_backward(call, saved, needs, grads)
        with torch.enable_grad():
            # only the inputs whose gradient is wanted are leaves that require
            # it, so autograd prunes the rest of the re-run's graph
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            outs = call.run_plain(leaves)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                      allow_unused=True) if pairs else [None] * len(wrt)
        it = iter(got)
        return (None,) + tuple(next(it) if t.requires_grad else None for t in leaves)

    @staticmethod
    def jvp(ctx, _, *tangents):
        call = ctx.call
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


def kernel_call(launch: Callable, plain: TorchExecutor, written: Sequence[str],
                env: Dict[str, torch.Tensor], scalars: Dict[str, Any], domain, origins,
                periodic) -> None:
    """Run ``launch(env, scalars, domain, origins, periodic)`` -- which
    fills the written fields of ``env`` in place -- as a differentiable
    operation: the written views receive the kernels' values through
    ``copy_``, which autograd records."""
    names = list(env)
    tensor_scalars = [n for n, v in scalars.items() if isinstance(v, torch.Tensor)]
    call = _Call(launch, plain, names, [n for n in names if n in written], tensor_scalars,
                 {n: v for n, v in scalars.items() if n not in tensor_scalars},
                 tuple(domain), dict(origins), tuple(periodic))
    outs = _KernelCall.apply(call, *[env[n] for n in names],
                             *[scalars[n] for n in tensor_scalars])
    for name, new in zip(call.written, outs):
        env[name].copy_(new)
