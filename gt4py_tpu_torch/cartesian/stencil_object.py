"""Call-time machinery: argument binding, origin normalization, domain
inference, validation, dispatch.

Counterpart of ``gt4py_tpu.cartesian.stencil_object`` (reference:
src/gt4py/cartesian/stencil_object.py:146-665).  Fields are torch tensors
(or ``FieldStorage`` holders, or numpy arrays on the CPU).  Every call hands
the backend an *environment*: one logical (I, J, K, *data_dims) view per
field.  Written fields are views of fresh output buffers, clones of the
arguments, so a buffer passed under two names (``in_field=u, out_field=u``)
is never read and written by one kernel: reads see the argument, writes go
to the clone, and the clone keeps the argument's halos.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.analysis import AccessKind, StencilAnalysis
from gt4py_tpu_torch.core import dtypes


class ArgumentError(ValueError):
    pass


def _tensor_of(value):
    """The tensor (sharing the argument's memory), ``__gt_origin__`` and
    ``FieldStorage`` holder (None for a bare array) of a field argument."""
    from gt4py_tpu_torch.storage import FieldStorage

    if isinstance(value, FieldStorage):
        return value.data, value.origin, value
    if isinstance(value, np.ndarray):
        # shares memory: in-place results reach the caller's array
        return torch.from_numpy(value), getattr(value, "__gt_origin__", None), None
    if isinstance(value, torch.Tensor):
        return value, getattr(value, "__gt_origin__", None), None
    raise ArgumentError(
        f"Field arguments must be torch tensors, FieldStorage or numpy arrays, "
        f"got {type(value).__name__}"
    )


def _distributed(field_args) -> bool:
    """Some field argument is a ``parallel.DistributedField``."""
    return any(getattr(v, "global_shape", None) is not None for v in field_args.values())


def _normalize_periodic(periodic) -> Tuple[str, ...]:
    """``periodic="I"`` / ``("I", "J")`` / ``"IJ"`` -> sorted axis tuple."""
    if not periodic:
        return ()
    out = []
    for ax in tuple(periodic):
        a = str(ax).upper()
        if a not in ("I", "J"):
            raise ArgumentError(f"periodic= accepts axes 'I' and 'J', got {ax!r}")
        out.append(a)
    return tuple(sorted(set(out)))


def logical_view(tensor: torch.Tensor, dimensions, data_ndim: int, physical: bool):
    """View of a field tensor with axes (I, J, K, *data_dims); axes the
    field lacks become size-1.  ``physical=True``: the tensor's spatial
    axes are in the K-leading (K, I, J) order (J contiguous), the layout
    the models keep end to end."""
    present = [ax for ax, m in zip("IJK", dimensions) if m]
    spatial = len(present)
    if tensor.ndim != spatial + data_ndim:
        raise ArgumentError(
            f"field has ndim {tensor.ndim}, expected {spatial + data_ndim}"
        )
    if physical:
        phys = [ax for ax in "KIJ" if ax in present]
        perm = [phys.index(ax) for ax in present]
        tensor = tensor.permute(*perm, *range(spatial, tensor.ndim))
    shape = list(tensor.shape)
    full = []
    it = iter(range(spatial))
    for m in dimensions:
        full.append(shape[next(it)] if m else 1)
    return tensor.reshape(full + shape[spatial:]) if spatial < 3 else tensor


def physical_of(view: torch.Tensor, dimensions, data_ndim: int, physical: bool):
    """The inverse of ``logical_view``: a view of the logical (I, J, K,
    *data_dims) tensor ``view`` with the field tensor's axes."""
    present = [ax for ax, m in zip("IJK", dimensions) if m]
    t = view.reshape([n for n, m in zip(view.shape[:3], dimensions) if m] + list(view.shape[3:]))
    if physical:
        phys = [ax for ax in "KIJ" if ax in present]
        t = t.permute(*[present.index(ax) for ax in phys], *range(len(present), t.ndim))
    return t


class StencilObject:
    """A built, callable stencil.

    Calling conventions mirror the JAX package: positional/keyword field and
    scalar arguments in declaration order, plus ``origin=``, ``domain=``,
    ``exec_info=``, ``validate_args=`` and ``periodic=`` keywords.  Results
    are written into the field arguments, so a written field cannot be a
    leaf tensor that requires grad: gradients go through ``functional``
    (as the models' ``step_fn`` calls it), where the written fields come
    back as new tensors.
    """

    def __init__(self, analysis: StencilAnalysis, backend, backend_name: str,
                 name: str, options: Dict[str, Any], stencil_id: str):
        self.analysis = analysis
        self.backend = backend
        self.backend_name = backend_name
        self.name = name
        self.options = options
        self.stencil_id = stencil_id
        self.field_info = analysis.field_info
        self.parameter_info = analysis.parameter_info
        self.ir = analysis.stencil

    # ------------------------------------------------------------------ #

    def __call__(self, *args, origin=None, domain=None, exec_info: Optional[dict] = None,
                 validate_args: bool = True, periodic=(), **kwargs):
        """Run in place on the arguments inside ``stencil_call_context``;
        keeps ``exec_info``'s times (and, under its ``"__aggregate_data"``
        key, per-stencil totals) and the ``call_time`` metric, as the JAX
        package's ``StencilObject.__call__`` does."""
        from gt4py_tpu_torch.instrumentation import (
            MetricLevel,
            collect_sample,
            stencil_call_context,
        )

        t0 = time.perf_counter()
        if exec_info is not None:
            exec_info["call_run_start_time"] = t0
        field_args, scalar_args = self._bind_args(args, kwargs)
        with stencil_call_context.activate(name=self.name, backend=self.backend_name):
            self._call_run(field_args, scalar_args, origin, domain, exec_info, validate_args,
                           periodic=periodic)
        t1 = time.perf_counter()
        if exec_info is not None:
            exec_info["call_run_end_time"] = t1
            # '__aggregate_data' magic key: per-stencil cumulative stats
            # (reference: backend/templates/stencil_module.py.in:125-158)
            if exec_info.get("__aggregate_data", False):
                agg = exec_info.setdefault(self.name, {})
                agg["call_time"] = t1 - t0
                agg["total_call_time"] = agg.get("total_call_time", 0.0) + (t1 - t0)
                agg["ncalls"] = agg.get("ncalls", 0) + 1
                if "run_end_time" in exec_info:
                    rt = exec_info["run_end_time"] - exec_info["run_start_time"]
                    agg["run_time"] = rt
                    agg["total_run_time"] = agg.get("total_run_time", 0.0) + rt
        collect_sample(self.name, "call_time", t1 - t0, MetricLevel.PERFORMANCE)

    def run(self, *, _domain_, _origin_, exec_info=None, **kwargs):
        """Low-level entry: explicit domain and per-field origins, no
        argument validation and no call hooks."""
        field_args = {}
        scalar_args = {}
        for p in self.ir.api_params:
            if p.name in kwargs:
                (field_args if p.is_field else scalar_args)[p.name] = kwargs[p.name]
        self._call_run(field_args, scalar_args, _origin_, _domain_, exec_info, False)

    def _call_run(self, field_args, scalar_args, origin, domain, exec_info, validate_args,
                  periodic=()) -> None:
        """Bind the field arguments' tensors and origins, execute, and
        write each written field's result into its argument."""
        tensors, origins = {}, {}
        origin_map = self._normalize_origin_arg(origin)
        if _distributed(field_args):
            origins = {n: self._field_origin(n, origin_map, getattr(v, "origin", None))
                       for n, v in field_args.items() if v is not None}
            outs = self._run_global(field_args, scalar_args, origins, domain, False,
                                    periodic, validate_args)
            for name, new in outs.items():
                field_args[name].data.copy_(new.data)
            return
        for name, value in field_args.items():
            if value is None:
                self._check_optional(name)
                continue
            tensor, attr_origin, holder = _tensor_of(value)
            if holder is None:
                tensor, attr_origin = self._reorder_duck_dims(name, value, tensor, attr_origin)
            tensors[name] = tensor
            origins[name] = self._field_origin(name, origin_map, attr_origin)
            if (tensor.is_leaf and tensor.requires_grad and torch.is_grad_enabled()
                    and self.field_info[name].access & AccessKind.WRITE):
                raise ArgumentError(
                    f"Field '{name}' is written in place but is a leaf tensor that requires "
                    f"grad; take gradients through functional(...)")
        outs = self._execute(tensors, scalar_args, origins, domain, physical=False,
                             periodic=periodic, validate_args=validate_args,
                             exec_info=exec_info)
        for name, new in outs.items():
            tensors[name].copy_(new)

    def _reorder_duck_dims(self, name, value, tensor, attr_origin):
        """Arguments carrying ``__gt_dims__`` in a different axis order
        get permuted (a view) to the stencil's declared order, and their
        ``__gt_origin__`` along (reference: the ``__gt_dims__`` storage
        protocol, backend/dace_stencil_object.py:33)."""
        gt_dims = getattr(value, "__gt_dims__", None)
        if gt_dims is None:
            return tensor, attr_origin
        decl = self.ir.field_decls.get(name)
        if decl is None:
            return tensor, attr_origin
        expected = [ax for ax, m in zip("IJK", decl.dimensions) if m]
        got = [str(d).upper() for d in gt_dims[: len(expected)]]
        if got == expected:
            return tensor, attr_origin
        if sorted(got) != sorted(expected):
            raise ArgumentError(
                f"Field '{name}': __gt_dims__ {tuple(gt_dims)} does not "
                f"match the declared axes {tuple(expected)}"
            )
        perm = [got.index(ax) for ax in expected]
        perm += list(range(len(expected), tensor.ndim))  # data axes stay
        tensor = tensor.permute(*perm)
        if attr_origin is not None:
            spatial = [attr_origin[p] for p in perm[: len(expected)]]
            attr_origin = tuple(spatial) + tuple(attr_origin[len(expected):])
        return tensor, attr_origin

    def functional(self, *, origin, domain, physical_layout: bool = False,
                   periodic=(), validate_args: bool = True):
        """Return ``fn(**fields_and_scalars) -> {written field: new tensor}``.

        The arguments are left unchanged: every written field comes back as
        a fresh tensor, a clone of its argument with the domain updated.
        With ``physical_layout=True`` fields are K-leading (K, I, J) tensors.
        ``periodic=("I", "J")``: reads beyond the domain wrap around it.
        """
        origin_map = self._normalize_origin_arg(origin)
        domain = tuple(int(d) for d in domain)
        periodic = _normalize_periodic(periodic)

        def fn(**kwargs):
            field_args, scalar_args = self._bind_args((), kwargs)
            if _distributed(field_args):
                origins = {n: self._field_origin(n, origin_map, None)
                           for n, v in field_args.items() if v is not None}
                return self._run_global(field_args, scalar_args, origins, domain,
                                        physical_layout, periodic, validate_args)
            tensors, origins = {}, {}
            for name, value in field_args.items():
                if value is None:
                    self._check_optional(name)
                    continue
                tensors[name] = _tensor_of(value)[0]
                origins[name] = self._field_origin(name, origin_map, None)
            return self._execute(tensors, scalar_args, origins, domain,
                                 physical=physical_layout, periodic=periodic,
                                 validate_args=validate_args)

        return fn

    def _run_global(self, field_args, scalar_args, origins, domain, physical, periodic,
                    validate_args):
        """A call on ``parallel.DistributedField``s: the single-device result
        on the global domain, from this rank's blocks (``run_global``).
        ``origins``: each given field's origin."""
        from gt4py_tpu_torch.parallel.distributed import run_global

        fields = {}
        for name, value in field_args.items():
            if value is None:
                self._check_optional(name)
            else:
                fields[name] = value
        return run_global(self, fields, scalar_args,
                          {n: self._origin3(n, origins[n]) for n in fields}, domain,
                          physical=physical, periodic=periodic, validate_args=validate_args)

    # ------------------------------------------------------------------ #

    def _execute(self, tensors, scalars, origins, domain, *, physical, periodic,
                 validate_args, exec_info=None, frame=None) -> Dict[str, torch.Tensor]:
        periodic = _normalize_periodic(periodic)
        views = {}
        for name, t in tensors.items():
            decl = self.ir.field_decls[name]
            try:
                views[name] = logical_view(t, decl.dimensions, len(decl.data_dims), physical)
            except ArgumentError as e:
                raise ArgumentError(f"Field '{name}': {e}") from None
        origins3 = {n: self._origin3(n, o) for n, o in origins.items()}
        if domain is None:
            domain = self._get_max_domain(views, origins3)
        domain = tuple(int(d) for d in domain)
        if validate_args:
            self._validate_args(views, scalars, origins3, domain)
        outs: Dict[str, torch.Tensor] = {}
        env = dict(views)
        for name in tensors:
            if self.field_info[name].access & AccessKind.WRITE:
                outs[name] = tensors[name].clone()
                decl = self.ir.field_decls[name]
                env[name] = logical_view(outs[name], decl.dimensions,
                                         len(decl.data_dims), physical)
        if exec_info is not None:
            exec_info["run_start_time"] = time.perf_counter()
        # a call under K8 gives back its written fields' new tensors
        # (autograd's outputs) instead of filling ``env``
        replaced: Dict[str, torch.Tensor] = {}
        self.backend.apply(env, scalars, domain, origins3, periodic, frame=frame,
                           outputs=replaced)
        for name, new in replaced.items():
            decl = self.ir.field_decls[name]
            outs[name] = physical_of(new, decl.dimensions, len(decl.data_dims), physical)
        if exec_info is not None:
            exec_info["run_end_time"] = time.perf_counter()
        return outs

    def _check_optional(self, name):
        info = self.field_info.get(name)
        if info is not None and info.access != AccessKind.NONE:
            raise ArgumentError(f"Field '{name}' is required but got None")

    def _bind_args(self, args, kwargs) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        field_args: Dict[str, Any] = {}
        scalar_args: Dict[str, Any] = {}
        params = self.ir.api_params
        if len(args) > len(params):
            raise ArgumentError(f"Too many positional arguments for stencil '{self.name}'")
        for p, a in zip(params, args):
            if p.is_keyword:
                raise ArgumentError(
                    f"Parameter '{p.name}' of stencil '{self.name}' is keyword-only"
                )
        pos = {p.name: a for p, a in zip(params, args)}
        known = {p.name for p in params}
        unknown = sorted(set(kwargs) - known)
        if unknown:
            raise ArgumentError(f"Unknown argument(s) {unknown} for stencil '{self.name}'")
        for p in params:
            if p.name in pos and p.name in kwargs:
                raise ArgumentError(f"Duplicate argument '{p.name}'")
            if p.name in pos:
                value = pos[p.name]
            elif p.name in kwargs:
                value = kwargs[p.name]
            elif p.optional:
                value = None
            else:
                raise ArgumentError(f"Missing argument '{p.name}' for stencil '{self.name}'")
            (field_args if p.is_field else scalar_args)[p.name] = value
        return field_args, scalar_args

    def _normalize_origin_arg(self, origin) -> Dict[str, Tuple[int, ...]]:
        if origin is None:
            return {}
        if isinstance(origin, dict):
            return dict(origin)
        return {"_all_": tuple(int(x) for x in origin)}

    def _field_origin(self, name, origin_map, attr_origin) -> Tuple[int, ...]:
        info = self.field_info[name]
        ndim = info.domain_ndim
        if name in origin_map:
            o = tuple(origin_map[name])
        elif "_all_" in origin_map:
            o = tuple(origin_map["_all_"])
        elif attr_origin is not None:
            o = tuple(attr_origin)
        else:
            o = (0,) * ndim
        if len(o) != ndim:
            full = tuple(o) + (0,) * (3 - len(o))
            o = tuple(c for c, present in zip(full, info.dimensions) if present)
        return tuple(int(x) for x in o)

    def _origin3(self, name, origin) -> Tuple[int, int, int]:
        it = iter(origin)
        return tuple(next(it) if m else 0 for m in self.field_info[name].dimensions)

    def _get_max_domain(self, views, origins3) -> Tuple[int, int, int]:
        """Largest domain compatible with all field shapes
        (reference: stencil_object._get_max_domain, :298-343)."""
        max_domain = [1 << 30] * 3
        for name, v in views.items():
            info = self.field_info[name]
            for ax, present in enumerate(info.dimensions):
                if not present:
                    continue
                upper = tuple(info.boundary)[ax][1]
                max_domain[ax] = min(max_domain[ax], v.shape[ax] - origins3[name][ax] - upper)
        for i, d in enumerate(max_domain):
            if d >= (1 << 30):
                max_domain[i] = 1
        if any(d <= 0 for d in max_domain):
            raise ArgumentError(
                f"Cannot infer a valid domain (got {tuple(max_domain)}); "
                "check field shapes, origins and halo requirements."
            )
        return tuple(max_domain)

    def _validate_args(self, views, scalars, origins3, domain) -> None:
        """Reference: stencil_object._validate_args (:345-497)."""
        if len(domain) != 3 or any(int(d) <= 0 for d in domain):
            raise ArgumentError(f"Invalid domain {domain}")
        if domain[2] < self.analysis.min_k_size:
            raise ArgumentError(
                f"Domain K size {domain[2]} is below the stencil minimum "
                f"{self.analysis.min_k_size}"
            )
        devices = {v.device for v in views.values()}
        if len(devices) > 1:
            raise ArgumentError(f"Fields live on several devices: {sorted(map(str, devices))}")
        for name, v in views.items():
            info = self.field_info[name]
            if dtypes.to_numpy(v.dtype) != np.dtype(info.dtype):
                raise ArgumentError(
                    f"Field '{name}' has dtype {dtypes.to_numpy(v.dtype)}, "
                    f"expected {np.dtype(info.dtype)}"
                )
            if info.data_dims and tuple(v.shape[3:]) != tuple(info.data_dims):
                raise ArgumentError(
                    f"Field '{name}' data dimensions {tuple(v.shape[3:])} "
                    f"!= declared {info.data_dims}"
                )
            for ax, present in enumerate(info.dimensions):
                if not present:
                    continue
                lower, upper = tuple(info.boundary)[ax]
                o = origins3[name][ax]
                if o < lower:
                    raise ArgumentError(
                        f"Origin {origins3[name]} of field '{name}' is below the halo "
                        f"requirement {lower} on axis {'IJK'[ax]}"
                    )
                need = o + domain[ax] + upper
                if v.shape[ax] < need:
                    raise ArgumentError(
                        f"Field '{name}' axis {'IJK'[ax]} has size {v.shape[ax]}, "
                        f"needs >= {need} (origin {o} + domain {domain[ax]} + halo {upper})"
                    )
        for name, pinfo in self.parameter_info.items():
            if scalars.get(name) is None and pinfo.access != AccessKind.NONE:
                raise ArgumentError(f"Missing scalar parameter '{name}'")

    # ------------------------------------------------------------------ #

    def freeze(self, *, origin, domain) -> "FrozenStencil":
        return FrozenStencil(self, origin, domain)

    #: ``lowered`` formats
    LOWERED_FORMATS = ("ir", "cuda", "plan")

    def lowered(self, *, domain=(8, 8, 4), format="ir", origin=None,  # noqa: A002
                physical_layout: bool = False, scalars=None):
        """The built program's text or plan WITHOUT executing (reference:
        the program-formatters registry, program_processors/
        program_formatter.py -- "dump backend source without running").

        ``format``: ``"ir"`` (GTScript-like stencil IR, any backend),
        ``"cuda"`` (the generated CUDA C++ source of the ``"cuda"``
        backend), or ``"plan"`` (the record a ``"cuda"`` call at ``domain``
        writes to ``cuda_backend.LAST_PLAN``: forms, tiles, staging, K4's
        blocks; planned on meta tensors, so nothing is allocated on a
        device, built or launched, and K4's CTAs a SM come from the
        shared-memory rule).  Shapes come from ``domain`` plus each field's
        halo boundary, dtypes and data dimensions from the signature; with
        ``physical_layout=True`` the fields are (K, I, J) buffers, else
        (I, J, K) ones.  ``scalars``: the values of scalars that interval
        bounds read.
        """
        if format == "ir":
            return self.pretty_ir()
        if format not in self.LOWERED_FORMATS:
            raise ValueError(f"unknown format '{format}' ({' | '.join(self.LOWERED_FORMATS)})")
        if not hasattr(self.backend, "program"):
            raise TypeError(
                f"Backend '{self.backend_name}' has no lowered form; "
                "use format='ir' or the 'cuda' backend."
            )
        if format == "cuda":
            return self.backend.source
        domain = tuple(int(d) for d in domain)
        if origin is None:
            origin = {name: info.boundary.lower_indices for name, info in self.field_info.items()}
        origin_map = self._normalize_origin_arg(origin)
        env, origins3 = {}, {}
        for name, info in self.field_info.items():
            decl = self.ir.field_decls[name]
            og = self._origin3(name, self._field_origin(name, origin_map, None))
            uppers = info.boundary.upper_indices
            shape = {ax: og[n] + domain[n] + uppers[n]
                     for n, (ax, m) in enumerate(zip("IJK", info.dimensions)) if m}
            axes = [ax for ax in ("KIJ" if physical_layout else "IJK") if ax in shape]
            t = torch.empty([shape[ax] for ax in axes] + list(info.data_dims),
                            dtype=dtypes.to_torch(info.dtype), device="meta")
            env[name] = logical_view(t, decl.dimensions, len(decl.data_dims), physical_layout)
            origins3[name] = og
        return self.backend.plan_call(env, dict(scalars or {}), domain, origins3,
                                      dry=True).plan

    def pretty_ir(self) -> str:
        """The lowered stencil IR as GTScript-like text (inspection parity
        with the reference's ``Program.gtir`` property)."""
        from gt4py_tpu_torch.cartesian.pretty import pformat_stencil

        return pformat_stencil(self.ir)

    def __str__(self) -> str:
        lines = [f"StencilObject '{self.name}' (backend={self.backend_name})"]
        for name, info in self.field_info.items():
            lines.append(
                f"  field {name}: dtype={info.dtype}, access={info.access}, "
                f"boundary={tuple(info.boundary)}"
            )
        for name, pinfo in self.parameter_info.items():
            lines.append(f"  param {name}: dtype={pinfo.dtype}")
        return "\n".join(lines)


class FrozenStencil:
    """Stencil with pre-validated origin/domain for low-overhead calls
    (reference: stencil_object.FrozenStencil, :94-143)."""

    def __init__(self, stencil_object: StencilObject, origin, domain):
        self.stencil_object = stencil_object
        self.origin = origin
        self.domain = tuple(domain)

    def __call__(self, **kwargs):
        field_args = {}
        scalar_args = {}
        for p in self.stencil_object.ir.api_params:
            if p.name in kwargs:
                (field_args if p.is_field else scalar_args)[p.name] = kwargs[p.name]
        self.stencil_object._call_run(
            field_args, scalar_args, self.origin, self.domain, None, False
        )
