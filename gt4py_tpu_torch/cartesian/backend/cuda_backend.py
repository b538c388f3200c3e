"""``backend="cuda"``: CUDA C++ kernels generated from the analysed IR.

The counterpart of the JAX package's Pallas kernel generator,
``PallasBackend._pallas_trace`` (gt4py_tpu/cartesian/backend/
pallas_backend.py:1428), re-thought for Hopper (sm_90a).  Two hand-written
emitters turn each vertical loop into ``__global__`` kernels:

- **Tile form** (K1, PARALLEL sections; Pallas ``_plan_rows``, whose one
  ``pallas_call`` per stencil keeps its temporaries in VMEM tiles).  Each
  PARALLEL section is one kernel (``<stencil>_k<n>_tile``) on a grid of
  (J tiles, I tiles, K blocks): a CTA of 256 threads runs a TI x TJ tile at
  ``TILE_KZ`` levels, one after another (the levels are independent).
  Within a level the statements split into stages as the plane-sweep form
  splits a plane (``_plane_stages``), each stage a block-stride loop over
  its rectangle widened by the extent analysis (halo points recomputed by
  every CTA that needs them), ``__syncthreads()`` between stages.  A
  temporary of the section read at an offset or in a later stage lives in
  a shared plane, one read only at offset 0 in one stage in a register
  (``_plan_planes``' split); planes whose stages do not overlap share a
  slot (``_assign_slots``); outputs are stored once, where the CTA owns
  the point.  A field the section reads at a horizontal offset and does
  not write is staged per level into a two-slot ring with ``cp.async``
  (16-byte copies from each row's aligned-down word at any row phase, K6;
  element copies where a word is not contiguous or would leave the
  field's storage; a twin kernel ``_u``, its rows' stride a constant,
  runs the calls whose staged rows all share one lead): level k + 1's
  tile copies while level k computes; fields read only at (0, 0) load
  straight to registers.  The
  tile is the largest of ``TILE_SHAPES`` whose shared bytes leave
  ``TILE_CTAS_PER_SM`` CTAs a SM.  The section declines (recorded in
  ``declined["tiles"]``) to the **stage-split row form** when it reads, at
  a K offset, a field it writes; when a data-dimension temporary is read
  at an offset; when a compound statement reads, at an offset, a field it
  writes; when its shared bytes exceed ``SMEM_MAX`` at the smallest tile;
  and, unless built with ``tiles=True``, when it is one stage
  (``ONE_STAGE``: nothing to keep on chip, and the row kernel was faster).
  The row form, also built with ``tiles=False``: a new stage starts at
  each read, at a nonzero offset, of a field written earlier in the stage
  (and at each write of a field the stage already read at an offset); each
  stage is one kernel over its extended rectangle, ``threadIdx.x`` along J,
  K a loop in the thread, the temporaries a later stage needs in scratch
  tensors.
- **Fused column form** (K2, FORWARD/BACKWARD loops; Pallas
  ``_plan_columns``, mode B's whole column in VMEM).  Consecutive serial
  loops are one kernel (``<stencil>_k<n>_col``) in which a thread owns one
  (i, j) column through every loop, 64 columns a CTA along J; they fuse
  unless one reads, at a horizontal offset, a field another writes
  (``declined["fuse_loops"]``).  A temporary read only at its level or the
  level before in the loop that writes it is carried in two registers and
  never stored; one read by a later loop of the kernel too is carried and
  stored once a level into its scratch tensor, which the later loop reads
  as a stream.
  Each section loads the inputs its statements read one level ahead, into
  registers.  With ``fuse_loops=False`` each loop is its own column
  kernel, its recurrence reads such as ``dcol[0, 0, -1]`` reading the
  level the same thread just wrote (scratch); those per-loop kernels are
  also K4's.
- **Plane-sweep form** (K5 and serial loops that read, at a horizontal
  offset, a field they write; Pallas ``_trace_serialized``/
  ``_serial_child`` and mode B's tiled serial sweep, ``_plan_columns``).
  One CTA per (TI x TJ) tile sweeps K in the loop's order; within a plane
  the statements split into stages as the row form splits them, each stage
  a block-stride loop over its extended rectangle (halo points recomputed
  by every CTA), ``__syncthreads()`` between stages and planes.  A
  plane-local temporary (``passes.plane_local_temps``) read at an offset
  lives in one shared-memory plane, one read at offset 0 in one stage in a
  register; a field the loop writes and reads at an offset is read from
  the CTA's own shared copy of the plane (loaded at the plane's start; a
  ring of planes for reads of earlier levels), and written to device
  memory only where the CTA owns the point; a read, at another CTA's
  points, of a value the sweep has not written yet reads a copy of the
  field taken just before the kernel.  A mixed stencil built with
  ``serialize=True`` runs its PARALLEL loops serialized
  (``passes.serialize_parallel_k``) in this form (by default it runs
  split: ``SERIALIZE_MIXED``); a read this form cannot order between CTAs
  declines it, naming the read.
- **Sweep form** (K5; Pallas ``_trace_serialized``, a mixed stencil
  all-serial in one kernel).  A serialized PARALLEL loop and the run of
  serial loops after it are one kernel (``<stencil>_k<n>_sweep``,
  ``SweepPlan``): one CTA of TI x TJ threads per tile, a thread a column,
  sweeps K once; the plane part runs ``lead`` levels ahead of the first
  column loop (its stages as the plane-sweep form runs a plane, its
  inputs staged a level ahead as the tile form stages them), and what the
  column loop reads of it at the CTA's own points stays in a shared ring
  of levels; the later loops run after the sweep, as the fused column
  kernel runs them.  Built with ``sweep=True`` only (it raises, naming
  what one sweep cannot order); a serialized build without it records in
  ``declined["sweep"]`` why the form declines or that it was not asked
  for, and runs the plane-sweep kernel and the fused column kernel.  A
  sweep build also holds those two for K4 and for a call whose sections
  overlap along K (``SweepPlan.ordered``).
- **K-blocked passes** (K4; Pallas ``_trace_kblocked``/``_run_k_blocks``).
  Each column-form loop has a K-blocked variant: one launch
  (``<loop>_kb``) in which every thread sweeps its column block by block
  in the loop's order, its sections' K bounds clipped per block in the
  kernel.  The window of the loop's read-only inputs for each block of KB
  levels lies in a ring of ``KB_SLOTS`` slots in shared memory: block
  b + 1's window is copied in with ``cp.async`` (``gt::async_copy``; 16
  bytes where a row is contiguous and aligned) while block b is swept.
  KB is the largest candidate whose ring leaves ``KB_CTAS_PER_SM`` CTAs
  on a SM.  Carries cross blocks in the scratch buffers.  Eligibility is
  the JAX package's.  Built with ``k_blocked`` unset, a stencil runs K4
  from ``KB_DEFAULT_DEPTH`` levels on at most ``KB_DEFAULT_COLUMNS``
  columns and one pass elsewhere (``kb_default``, PERF.md);
  ``k_blocked=False`` keeps one pass.  The library counts its launches
  (``gt_launch_counts``: in all, by kernel, and of each kernel's K4 and
  vector variants); the plan records each loop's.
- **Row-phase 16-byte staging and the vector row form** (K6; Pallas
  ``_trace_repaired`` and its gate ``_halos_ij``).  The tile and sweep
  kernels stage each row of an input from its own aligned-down 16-byte
  word, at any row phase (``_emit_staging``), so no call is repaired by
  default; ``repair=True`` still runs the JAX package's pass
  (``repair``).  Every row stage that reaches a J-contiguous field has a
  second kernel in which a thread computes V consecutive J points (V = 16
  bytes over the smallest item size), each read-only field read as
  aligned 16-byte words into a register window per (I offset, K offset)
  row, each written field held in a register array and stored as words;
  partial groups, a window past what its readers need and a periodic J
  seam take elements one by one.  Its groups start on the fields' common
  16-byte phase, checked at every launch from the views' pointers and
  strides; a call whose fields share none runs the scalar row kernels.
  ``gt_run`` takes a flag per stage: geometry never rebuilds.
- **Periodic wrap** (K1a; Pallas ``_plan_segments``/``_circular_ok``).
  Reads of read-only API fields on a periodic axis wrap by index arithmetic
  in the load address; there is no fill pass.  A written field read at a
  horizontal offset is filled in its fresh output buffer before the kernels
  (the oracle's pre-run fill).
- **Variable and absolute K** (K3; ``JaxTracer._read_nonuniform_k``, whose
  TPU kernel keeps the column in VMEM).  A row stage that reads, at a
  variable K, a 3-D field the stencil only reads runs in the **staged
  form** (``VarkPlan``, ``_emit_vark``; ``LAST_PLAN[name]["vark"]``): a
  CTA of ``VK_TILE`` columns times ``VK_LANES`` levels marches the stage's
  levels, the field's levels for its columns in a shared-memory window --
  the whole buffer column when it fits ``VK_BUDGET``, else a ring of levels
  around the step refilled with ``cp.async`` -- each window row staged
  from its aligned-down 16-byte word; the read is a shared-memory load at
  the level clipped to the buffer's K range, as the oracle clips, and a
  level the window does not hold loads from device memory and is counted
  (``CudaBackend.outside_reads``).  ``stage_vark=False`` keeps the row
  kernels; a multi-stage section the tile form runs keeps its
  variable-K reads in device memory (``VARK_IN_TILE``).  Elsewhere the
  read is a direct load at the clipped level.  A read at an absolute K
  whose index does not vary along K (a literal, a scalar, a field without
  a K axis) and whose field the kernel does not write is loaded once,
  before the K loop (``_hoistable``): into a register in the row, vector
  row, staged and fused column forms, a shared plane in the tile and
  plane-sweep forms.  In the row form a variable-K read of a field written
  earlier in the stage starts a new stage, like a nonzero offset; in the
  column form it reads what the sweep has written so far.
- **Data dimensions** (K7; Pallas ``_trace_split_data_dims``).  A field
  ``(K, I, J, *D)`` is passed whole with its data strides; a component is
  one more term in the load or store address.  Constant indices fold,
  per-point indices wrap modulo the dimension as the oracle's do.

``while`` loops run as loops in the thread, and horizontal regions as a
test of the thread's position against the regions, resolved against the
true domain (``dI``, ``dJ``), not the kernel's extended rectangle.

Types follow the oracle's C-style promotion: every operand is cast to the
promoted dtype and every literal is emitted exactly, in the dtype the
analysis gave it (hex floats with an ``f`` suffix in float32), so no float32
chain silently computes in double.

float16 and bfloat16 are storage types (Pallas ``_f16_reads_all_widened``):
a field, scratch temporary or scalar of float16 is stored as ``__half``,
loaded with ``__half2float`` and stored with ``__float2half_rn`` (round to
nearest even, as torch's ``.half()``); bfloat16 likewise as
``__nv_bfloat16`` with ``__bfloat162float`` and ``__float2bfloat16_rn``.
Every 16-bit value in a kernel is a ``float`` that holds a 16-bit number:
an operation whose promoted dtype is float16 or bfloat16 computes in float
and rounds (``gt::round_half``, ``gt::round_bf16``), which is the correctly
rounded result, as numpy (and ml_dtypes) give it.  The builder's
``passes.widen_f16_compute`` leaves only casts and stores at 16 bits, so a
cartesian stencil's body computes in float32 (or float64 where its
literals are float64; a float64 value is rounded to float16 once, with
``__double2half``, and to bfloat16 through float32, as torch and the JAX
package's oracle round it).

This backend does not inline temporaries (``passes.inline_parallel_
temporaries``, which the ``"jax"`` backend applies): the horizontal
diffusion is one tile kernel of three stages.  IR outside the emitters'
subset -- a data-dimension field read without all its indices, a write at
a variable K -- raises ``NotImplementedError`` when the stencil is built.
Nothing falls back to the plain executor on the GPU: CPU tensors run the
plain executor (``torch_backend``), CUDA tensors run the kernels or
raise.

Derivatives (K8; Pallas ``_trace_env``'s custom JVP): when a derivative is
wanted, the launch runs inside ``autodiff``'s ``torch.autograd.Function``
-- the primal from the kernels, the gradient and the tangent from the
adjoint and tangent stencils that ``derivative`` generates from the IR and
this backend builds at the first derivative call (``CudaBackend.derivative``,
one build per set of wanted inputs; the adjoint also per level count and
periodic axes), which get every form above; a construct without a
gather-form adjoint keeps the plain executor's re-run, named in
``LAST_PLAN[name]["adjoint"]``.  Otherwise the kernels run alone, as for
serving.

``LAST_PLAN[stencil name]`` records each stencil's plan: its kernels'
forms, the tile kernels' tiles, slots, shared bytes and staged inputs
(``tiles``), the fused column kernels' carried and whole-column
temporaries (``columns``), whether it was
serialized or K-blocked (passes, KB, launches per
loop, slots, shared bytes and CTAs per SM of the ring, promoted
temporaries), the plane tile, where temporaries live, writers the
plane-sweep form widened for ring reads (``widened``), the sweep kernels'
tile, lead, ring and CTAs a SM (``sweep``), the 16-byte word width
(``vector``), each 16-byte staged field's staging (``staging``:
``"row_phase"`` or ``"element"``) and the repaired fields' pads
(``repair``) of the last call, and why a form declined.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field, replace
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gt4py_tpu_torch.cartesian import derivative, ir, passes
from gt4py_tpu_torch.cartesian.analysis import (
    StencilAnalysis,
    analyze,
    _stmt_reads,
    _stmt_writes,
    default_float_dtype,
    default_int_dtype,
    promote_dtypes,
    try_static_int,
)
from gt4py_tpu_torch.cartesian.backend import _build, autodiff, register, repair
from gt4py_tpu_torch.cartesian.backend.torch_backend import (
    TorchExecutor,
    check_periodic,
    has_horizontal_reads,
    periodic_fill,
    run_plain,
    wants_derivative,
)
from gt4py_tpu_torch.core import dtypes
from gt4py_tpu_torch.core.definitions import BFLOAT16, Extent, is_float_dtype

#: the TPU kernels this backend replaces (file:line in the JAX package)
REPLACES = {
    "rows": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
            "PallasBackend._pallas_trace, row-tile form (_plan_rows :985)",
    "columns": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
               "PallasBackend._pallas_trace, column form (_plan_columns :1187)",
    "tile": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
            "PallasBackend._pallas_trace, row-tile form (_plan_rows :985; one pallas_call "
            "per stencil :2231, temporaries in VMEM scratch :2184-2199)",
    "column": "gt4py_tpu/cartesian/backend/pallas_backend.py:1428 "
              "PallasBackend._pallas_trace, column form (_plan_columns :1187, every serial "
              "loop in one pallas_call)",
    "wrap": "gt4py_tpu/cartesian/backend/pallas_backend.py:1702 _plan_segments, "
            ":897 _circular_ok (periodic wrap inside the tile loads)",
    "vark": "gt4py_tpu/cartesian/backend/jax_backend.py:1139 "
            "JaxTracer._read_nonuniform_k (kernel branch :1187-1207), inside K1/K2",
    "data_dims": "gt4py_tpu/cartesian/backend/pallas_backend.py:312 "
                 "PallasBackend._trace_split_data_dims",
    "autodiff": "gt4py_tpu/cartesian/backend/pallas_backend.py:178 "
                "PallasBackend._trace_env (custom_jvp around the kernel call; its tangent "
                "JaxBackend._trace_env, jax_backend.py:1554, transposed by jax.grad)",
    "planes": "gt4py_tpu/cartesian/backend/pallas_backend.py:797 "
              "PallasBackend._trace_serialized (_serial_child :765; mode B's tiled serial "
              "sweep, _plan_columns :1187)",
    "sweep": "gt4py_tpu/cartesian/backend/pallas_backend.py:797 "
             "PallasBackend._trace_serialized (_serial_child :765; a mixed stencil all-serial in "
             "one kernel)",
    "kblocked": "gt4py_tpu/cartesian/backend/pallas_backend.py:1297 "
                "PallasBackend._trace_kblocked (_run_k_blocks :1382)",
    "repair": "gt4py_tpu/cartesian/backend/pallas_backend.py:483 "
              "PallasBackend._trace_repaired (_repair_pads :389, _padded_metas :441, "
              "_repair_cost_ok :455; gate _halos_ij :946-978)",
}

#: the plan of every stencil built, by name (see the module docstring)
LAST_PLAN: Dict[str, dict] = {}
#: the stencil libraries this process has loaded: build directory ->
#: (library, kernels); stencils built from one source share one
_LOADED: Dict[str, Tuple[ctypes.CDLL, int]] = {}

#: shared memory one CTA may hold on the H100 (above 48 KiB a kernel asks
#: for it with cudaFuncSetAttribute)
SMEM_MAX = 227 * 1024
SMEM_DEFAULT = 48 * 1024
#: a plane-sweep CTA's threads, and its (TI, TJ) tiles, first choice first:
#: 16 x 32 gives 32 x 16 = 512 CTAs at 512 x 512 (about 3.9 per SM), then
#: smaller tiles until the shared planes fit
PLANE_THREADS = 256
PLANE_TILES = ((16, 32), (8, 32), (4, 32), (2, 32), (1, 32))
#: the tile form (K1): its (TI, TJ) candidates, largest first; a CTA runs
#: ``TILE_KZ`` levels of a PARALLEL section one after another; the tile is
#: the largest whose shared bytes leave ``TILE_CTAS_PER_SM`` CTAs a SM
#: (else ``TILE_CTAS_MIN``, else one).  On the H100 (``chip_smoke.py
#: --tile-sweep``, PERF.md) that rule picked the fastest of 16x32, 32x32
#: and 32x64 for hdiff, sw_step (32x64) and fv_step (32x32), and 4 levels
#: a CTA beat 8 and 16 for each
TILE_SHAPES = ((32, 64), (32, 32), (16, 32), (8, 32), (4, 32), (2, 32), (1, 32))
TILE_KZ = 4
TILE_CTAS_PER_SM = 3
TILE_CTAS_MIN = 2
#: a one-stage section has no intermediate to keep on chip, so by default
#: it runs the stage-split row kernel (``tiles=True`` forces the tile
#: form): on the H100 sl_step's tile kernel took more device time than its
#: vector row kernel in every chip call (``chip_smoke.py`` phase 12, PERF.md)
ONE_STAGE = ("cuda backend: one stage, nothing to keep on chip between stages: the row "
             "kernel (tiles=True forces the tile form)")
#: the staged form of variable-K reads (K3): a CTA of ``VK_TILE`` (I, J)
#: columns times ``VK_LANES`` levels (256 threads) marches the stage's K
#: range ``VK_LANES`` levels a step, the levels of each gathered field in
#: a shared-memory window: the whole buffer column when it fits
#: ``VK_BUDGET`` bytes (``VK_CTAS_PER_SM`` CTAs a SM, the most 256-thread
#: CTAs a SM holds), else a ring of levels around the step, at least
#: ``VK_MIN_RING`` deep.  On the H100 (``chip_smoke.py --k3-tiles``,
#: PERF.md, K3) variable_k_offset at 512 x 512 x 80 float64 took 0.1834 ms
#: of device time at 1 x 32 x 8 (8 CTAs a SM), 0.2036 at 1 x 64 x 4 and
#: 0.2059 at 2 x 32 x 4 (5 CTAs a SM each, the whole column)
VK_TILE = (1, 32)
VK_LANES = 8
VK_CTAS_PER_SM = 8
VK_BUDGET = (228 * 1024) // VK_CTAS_PER_SM - 1024
VK_MIN_RING = 2 * VK_LANES + 1
#: why a section the tile form runs keeps its variable-K reads in device
#: memory: its stages share on-chip planes level by level
VARK_IN_TILE = ("cuda backend: the tile form runs the section, its variable-K reads loaded "
                "from device memory (stage_vark=True runs its row stages in the staged form)")
#: the sweep form (K5): its (TI, TJ) tiles, first choice first, one thread
#: a column (TI TJ threads); the first whose shared bytes fit; a ring
#: deeper than ``SWEEP_RING_MAX`` levels declines.  On the
#: H100 (``chip_smoke.py --k6-k5``, PERF.md, K5) the fused MiniDycore
#: stencil's sweep took 0.79 ms of device time at 4 x 32, 0.95 at 8 x 32
#: and 4 x 64, 1.34-1.35 at 16 x 32 and 8 x 64
SWEEP_TILES = ((4, 32), (8, 32), (16, 32))
SWEEP_RING_MAX = 8
#: whether a mixed stencil built with ``serialize`` and ``sweep`` unset
#: runs serialized (its PARALLEL loops in the plane-sweep form) or split
#: (tile or row kernels, then the fused column kernels).
#: On the H100 (NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py --k6-k5``
#: and phase 4, PERF.md, K5) the fused MiniDycore stencil at 512 x 512 x 80
#: float32 in the sweep form lost every back-to-back pair to its split
#: build, 25 of 25 over five runs (0.9766-1.0079 against 0.7273-0.8914
#: ms), its kernel 0.7860-0.7922 ms of device time against the split
#: build's 0.5377-0.5537; so mixed stencils run split by default
SERIALIZE_MIXED = False
#: the reason a mixed stencil's split default records
SPLIT_MIXED = ("cuda backend: the split build, the default for a mixed stencil "
               "(serialize=True or sweep=True serializes it)")
#: why a serialized build without ``sweep=True`` keeps the plane-sweep
#: kernel and the fused column kernel where the sweep form would plan
SWEEP_OPT_IN = ("cuda backend: the plane-sweep and fused column kernels (sweep=True builds "
                "the sweep kernel)")
#: why a call runs a sweep's plane and fused column kernels instead
SWEEP_UNORDERED = ("cuda backend: this call's section bounds overlap within a loop (a shallow "
                   "domain): the plane and fused column kernels")
#: the fused column kernel (K2): columns a CTA (threads along J), and the
#: CTAs a SM its registers must leave (64 registers a thread).  On the H100
#: (``chip_smoke.py`` phase 12, PERF.md) vadv_update's kernel at
#: 512 x 512 x 80 float32 took 72 registers and 0.416 ms without the bound
#: (14 CTAs a SM: 2.2 waves of its 4096 CTAs), 0.36 at 64
COL_THREADS = 64
COL_MIN_CTAS = 16
#: the K-window kernel's tile of columns: threads along J and I
KB_TILE_J, KB_TILE_I = 32, 2
#: K block sizes K4 tries after the whole depth (Pallas ``_KB_CANDIDATES``)
KB_CANDIDATES = (512, 256, 128, 64, 32, 16, 8)
#: K4's ring: slots of KB levels in shared memory (block b + 1 loads while
#: block b is swept), and the CTAs a SM should hold: KB is the largest
#: candidate whose ring leaves that many CTAs of the H100's 228 KiB of
#: shared memory a SM (1 KiB of it reserved per CTA)
KB_SLOTS = 2
KB_CTAS_PER_SM = 4
SMEM_PER_SM = 228 * 1024
SMEM_PER_CTA_RESERVED = 1024
KB_SMEM_BUDGET = SMEM_PER_SM // KB_CTAS_PER_SM - SMEM_PER_CTA_RESERVED


def ctas_per_sm(smem: int, threads: int) -> int:
    """CTAs of ``threads`` threads and ``smem`` shared bytes one H100 SM
    holds by its shared memory and its 2048 threads (registers aside)."""
    return min(SMEM_PER_SM // (smem + SMEM_PER_CTA_RESERVED), 2048 // threads)


#: Built with ``k_blocked`` unset, a stencil runs K4 (where it is
#: eligible) on a depth of at least ``KB_DEFAULT_DEPTH`` levels and at
#: most ``KB_DEFAULT_COLUMNS`` columns, one pass elsewhere; ``k_blocked=
#: True`` blocks everywhere, ``False`` nowhere.  On the H100 (vadv_update
#: float32, back-to-back pairs of ``chip_smoke.py`` phase 10, PERF.md) K4
#: won every pair at 128 x 128 from 512 levels (at 256 the runs
#: disagreed) and at 256 x 256 at 512 and 2048 levels; at 512 x 512 the
#: two were within 0.7 % (K4 behind at 512 levels, ahead at 2048): one
#: pass there already has a thread for most of the card.
KB_DEFAULT_DEPTH = 512
KB_DEFAULT_COLUMNS = 256 * 256
#: the reason the default records where it keeps one pass
KB_DEFAULT_ONE_PASS = "one pass, the default (k_blocked=True blocks)"


def kb_default(columns: int, dK: int) -> bool:
    """Whether a stencil built with ``k_blocked`` unset runs K4 (where it
    is eligible) on ``columns`` = dI x dJ columns of ``dK`` levels."""
    return dK >= KB_DEFAULT_DEPTH and columns <= KB_DEFAULT_COLUMNS


#: the reason a plan records where the default runs K4
KB_DEFAULT_REASON = (f"the default at a depth of {KB_DEFAULT_DEPTH} levels or more on at "
                     f"most {KB_DEFAULT_COLUMNS} columns")

#: threads per block along J (coalesced) and I
BLOCK_J, BLOCK_I = 64, 4
#: the vector kernels' threads per block along J (each V points) and I,
#: and the blocks along K that share a stage's levels (a thread computes
#: V points where the scalar kernel's computes one: the split keeps as
#: many loads in flight)
VBLOCK_J, VBLOCK_I = 16, 16
VSPLIT_K = 4
#: whether a row stage runs its vector kernel when the build leaves
#: ``vector`` unset (chosen by measurement: PERF.md, K6)
VECTOR_DEFAULT = True
#: data dimensions a field may have (``gt::kMaxDataDims``)
MAX_DATA_DIMS = 4
#: per-field record the wrapper passes: I, J, K strides, the data strides,
#: the buffer's K range [klo, khi] in domain-relative levels, and the first
#: and last-plus-one byte address of its storage
_REC = 3 + MAX_DATA_DIMS + 4

#: storage C type of each dtype (``_ctype`` gives the type of a value)
_CTYPE = {
    np.dtype(np.bool_): "bool",
    np.dtype(np.int8): "signed char",
    np.dtype(np.int16): "short",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "long long",
    np.dtype(np.uint8): "unsigned char",
    np.dtype(np.float16): "__half",
    BFLOAT16: "__nv_bfloat16",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}
_F16 = np.dtype(np.float16)
#: 16-bit storage dtype -> (load, store, round) of its values
_HALF = {
    _F16: ("__half2float", "__float2half_rn", "gt::round_half"),
    BFLOAT16: ("__bfloat162float", "__float2bfloat16_rn", "gt::round_bf16"),
}
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_I64 = np.dtype(np.int64)
_BOOL = np.dtype(np.bool_)

_BINOP_SYM = {
    ir.BinaryOperator.ADD: "+",
    ir.BinaryOperator.SUB: "-",
    ir.BinaryOperator.MUL: "*",
    ir.BinaryOperator.EQ: "==",
    ir.BinaryOperator.NE: "!=",
    ir.BinaryOperator.LT: "<",
    ir.BinaryOperator.LE: "<=",
    ir.BinaryOperator.GT: ">",
    ir.BinaryOperator.GE: ">=",
    ir.BinaryOperator.BIT_AND: "&",
    ir.BinaryOperator.BIT_OR: "|",
    ir.BinaryOperator.BIT_XOR: "^",
}

#: math builtin -> (float32 name, float64 name); integer arguments of
#: these compute in float64, as numpy's ufuncs do
_FLOAT_FUNCS = {
    ir.NativeFunction.SIN: ("sinf", "sin"),
    ir.NativeFunction.COS: ("cosf", "cos"),
    ir.NativeFunction.TAN: ("tanf", "tan"),
    ir.NativeFunction.ARCSIN: ("asinf", "asin"),
    ir.NativeFunction.ARCCOS: ("acosf", "acos"),
    ir.NativeFunction.ARCTAN: ("atanf", "atan"),
    ir.NativeFunction.ARCTAN2: ("atan2f", "atan2"),
    ir.NativeFunction.SINH: ("sinhf", "sinh"),
    ir.NativeFunction.COSH: ("coshf", "cosh"),
    ir.NativeFunction.TANH: ("tanhf", "tanh"),
    ir.NativeFunction.ARCSINH: ("asinhf", "asinh"),
    ir.NativeFunction.ARCCOSH: ("acoshf", "acosh"),
    ir.NativeFunction.ARCTANH: ("atanhf", "atanh"),
    ir.NativeFunction.SQRT: ("sqrtf", "sqrt"),
    ir.NativeFunction.EXP: ("expf", "exp"),
    ir.NativeFunction.LOG: ("logf", "log"),
    ir.NativeFunction.LOG10: ("log10f", "log10"),
    ir.NativeFunction.LOG2: ("log2f", "log2"),
    ir.NativeFunction.GAMMA: ("tgammaf", "tgamma"),
    ir.NativeFunction.CBRT: ("cbrtf", "cbrt"),
    ir.NativeFunction.FLOOR: ("floorf", "floor"),
    ir.NativeFunction.CEIL: ("ceilf", "ceil"),
    ir.NativeFunction.TRUNC: ("truncf", "trunc"),
    ir.NativeFunction.ROUND: ("rintf", "rint"),  # half to even, as np.round
    ir.NativeFunction.ROUND_AWAY_FROM_ZERO: ("roundf", "round"),
    ir.NativeFunction.ERF: ("erff", "erf"),
    ir.NativeFunction.ERFC: ("erfcf", "erfc"),
}
_BOOL_FUNCS = {
    ir.NativeFunction.ISFINITE: "isfinite",
    ir.NativeFunction.ISINF: "isinf",
    ir.NativeFunction.ISNAN: "isnan",
}


def _ctype(dt) -> str:
    """C type of a value: a float16 or bfloat16 value is a ``float``."""
    return "float" if np.dtype(dt) in _HALF else _CTYPE[np.dtype(dt)]


def _stype(dt) -> str:
    """C type of a stored element (``__half`` for float16,
    ``__nv_bfloat16`` for bfloat16)."""
    return _CTYPE[np.dtype(dt)]


def _cast(code: str, src, dst) -> str:
    if np.dtype(src) == np.dtype(dst):
        return code
    if np.dtype(dst) in _HALF:
        return f"{_HALF[np.dtype(dst)][2]}({code})"
    return f"(({_ctype(dst)})({code}))"


def _rounded(code: str, dt) -> str:
    """The result of an operation computed in float, rounded to its
    16-bit dtype when it has one."""
    half = _HALF.get(np.dtype(dt))
    return f"{half[2]}({code})" if half else code


def _literal(value, dt) -> str:
    dt = np.dtype(dt)
    if dt == _BOOL:
        return "true" if value else "false"
    if is_float_dtype(dt):
        v = float(dtypes.scalar_value(value, dt))
        ct = _ctype(dt)
        if v != v:
            return f"(({ct})NAN)"
        if v in (float("inf"), float("-inf")):
            return f"(({ct})({'-' if v < 0 else ''}INFINITY))"
        # hex floats are exact; the f suffix keeps float32 (and float16)
        # chains in float
        return f"({v.hex()}{'f' if dt in _HALF or dt == _F32 else ''})"
    return f"(({_ctype(dt)}){int(np.asarray(value, dtype=dt))}LL)"


def _nonzero(off) -> bool:
    """True for a read that may reach another point or level: a nonzero
    offset, or a variable or absolute K."""
    if not isinstance(off, ir.CartesianOffset):
        return True
    return bool(off.i or off.j or off.k)


def _static_component(value: int, size: int, name: str) -> int:
    """A constant data index, with Python's negative indexing (the oracle
    indexes the array with it)."""
    if not -size <= value < size:
        raise IndexError(f"data index {value} out of range for field '{name}' ({size})")
    return value % size


def _framed(st: ir.Stencil) -> bool:
    """The stencil's code depends on where its domain lies in a larger one:
    it has horizontal regions, or reads the I or J position or size.  Its
    kernels then take the region frame ``gI0, gJ0, gNI, gNJ`` (the call's
    domain starts at (gI0, gJ0) of a gNI x gNJ domain)."""
    return any(isinstance(x, ir.HorizontalRestriction) or (
        isinstance(x, (ir.AxisPosition, ir.AxisSize)) and x.axis in ("I", "J"))
        for loop in st.vertical_loops for sec in loop.sections for s in sec.body
        for x in ir.walk_values(s))


def _region_test(masks: Sequence[ir.HorizontalMask], framed: bool = False) -> str:
    """The thread's (i, j) lies in one of the regions.  START and END
    anchors resolve against the true domain sizes ``dI`` and ``dJ``, as the
    oracle's ``HorizontalInterval.resolve`` does (``framed``: the point's
    place ``i + gI0`` in the frame's domain of ``gNI``); an open side tests
    nothing."""
    tests = []
    axes = (("(i + gI0)", "gNI"), ("(j + gJ0)", "gNJ")) if framed else (("i", "dI"), ("j", "dJ"))
    for m in masks:
        parts = []
        for (var, dom), itv in zip(axes, (m.i, m.j)):
            for bound, op in ((itv.start, ">="), (itv.end, "<")):
                if bound is None:
                    continue
                at = str(bound.offset) if bound.level == ir.LevelMarker.START \
                    else f"({dom} + {bound.offset})"
                parts.append(f"{var} {op} {at}")
        tests.append(f"({' && '.join(parts)})" if parts else "true")
    return " || ".join(tests) if tests else "false"


def _check_supported(analysis: StencilAnalysis) -> None:
    """Raise ``NotImplementedError`` naming the first IR node outside the
    emitters' subset."""
    st = analysis.stencil
    for name, decl in {**st.field_decls, **st.temp_decls}.items():
        if len(decl.data_dims) > MAX_DATA_DIMS:
            raise NotImplementedError(
                f"cuda backend: field '{name}' has more than {MAX_DATA_DIMS} data dimensions"
            )
        if np.dtype(decl.dtype) not in _CTYPE:
            raise NotImplementedError(
                f"cuda backend: field '{name}' has dtype {np.dtype(decl.dtype)}"
            )
    for name, decl in st.scalar_decls.items():
        if decl.dtype is None or np.dtype(decl.dtype) not in _CTYPE:
            raise NotImplementedError(
                f"cuda backend: scalar '{name}' has dtype {decl.dtype}"
            )
    for node in ir.walk_values(st.vertical_loops):
        if isinstance(node, ir.Assign) and not isinstance(node.target.offset, ir.CartesianOffset):
            raise NotImplementedError(
                f"cuda backend: write to '{node.target.name}' at a "
                f"{type(node.target.offset).__name__}"
            )
        if isinstance(node, ir.FieldAccess):
            dims = st.decl(node.name).data_dims
            if len(node.data_index) != len(dims):
                raise NotImplementedError(
                    f"cuda backend: field '{node.name}' with data dimensions {dims} is "
                    f"accessed with {len(node.data_index)} indices"
                )
        if isinstance(node, ir.NativeFuncCall) and node.func not in _FLOAT_FUNCS and \
                node.func not in _BOOL_FUNCS and node.func not in (
                    ir.NativeFunction.ABS, ir.NativeFunction.MIN, ir.NativeFunction.MAX,
                    ir.NativeFunction.MOD, ir.NativeFunction.POW):
            raise NotImplementedError(f"cuda backend: no emitter for builtin {node.func.value}")


# --------------------------------------------------------------------------- #
# kernel planning
# --------------------------------------------------------------------------- #


class _Decline(NotImplementedError):
    """A form cannot run a loop; the message names what it cannot order."""


class _Forced(_Decline):
    """A form the build option forces cannot run: raised, never recorded."""


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _value_size(dt) -> int:
    """Bytes of a value in shared memory (16-bit floats are held as float)."""
    return 4 if np.dtype(dt) in _HALF else np.dtype(dt).itemsize


def _ij(off) -> bool:
    return isinstance(off, ir.CartesianOffset) and bool(off.i or off.j)


@dataclass
class PlanePlan:
    """The plane-sweep form of one serial loop."""

    tile: Tuple[int, int]
    #: section index -> its stages (statement lists), in order
    stages: Dict[int, List[List[ir.Stmt]]]
    #: name -> extent of its shared-memory plane (plane-local temporaries
    #: read at an offset or across stages, and the mirrored fields)
    shared: Dict[str, Extent]
    #: fields the loop writes and reads at an offset -> the planes the CTA
    #: keeps of them (1, or more for reads of earlier planes): written to
    #: the shared ring and, where the CTA owns the point, to device memory
    mirrored: Dict[str, int]
    #: plane-local temporaries held in a register of one stage
    registers: List[str]
    smem_bytes: int
    #: fields the loop writes and reads, at another CTA's points, before
    #: the sweep has written them (a later level, or the plane's own level
    #: before its write): those reads (by ``id``) go to a copy of the field
    #: taken just before the kernel
    snapshots: List[str] = field(default_factory=list)
    snapshot_reads: frozenset = frozenset()
    #: writers (by ``id``) whose rectangle grows within the tile so that the
    #: CTA computes, into its ring, the points an earlier level's read
    #: reaches; clipped at run time to the statement's own extent in the
    #: domain, where the oracle computes it
    widened: Dict[int, Extent] = field(default_factory=dict)
    #: field -> the union of its writers' widened rectangles
    widened_fields: Dict[str, Extent] = field(default_factory=dict)
    #: K-invariant absolute reads (``_hoistable``) loaded into shared
    #: planes before the K loop: (read, the rectangle of the statements
    #: that read it (tile-relative), the same in the domain, unwidened)
    hoisted: List[Tuple[ir.FieldAccess, Extent, Extent]] = field(default_factory=list)
    #: compound statements (by ``id``) that read, at the point, a field
    #: they write, which no statement before them in the section wrote ->
    #: those fields: the point's element of the shared plane is primed
    #: from the snapshot before the statement, and every such read (the
    #: later ones after the statement's own writes: a ``while`` condition)
    #: reads the plane
    primed: Dict[int, List[str]] = field(default_factory=dict)
    #: ``while`` loops (by ``id``) that read at a horizontal offset a field
    #: they write, run one iteration at a time by the whole CTA
    #: (``_loop_group``): their body's stages and the rectangle (the
    #: statement's extent grown by the reach of those reads) the CTA
    #: iterates over, clipped to the statement's extent in the domain
    loops: Dict[int, Tuple[List[List[ir.Stmt]], Extent]] = field(default_factory=dict)
    #: why the ring cannot hold the earlier levels the loop reads (a writer
    #: that cannot be widened, ``_widen_writers``): the kernel then runs one
    #: launch a level, in the loop's order, and reads earlier levels from
    #: device memory, where every CTA's launch before wrote them
    per_level: Optional[str] = None

    def extent(self, analysis: StencilAnalysis, s: ir.Stmt) -> Extent:
        """The rectangle the CTA computes ``s`` over (tile-relative)."""
        if id(s) in self.loops:
            return self.loops[id(s)][1]
        return self.widened.get(id(s)) or analysis.extents.stmt_extent(s)

    def mask_bytes(self, tile: Tuple[int, int]) -> List[int]:
        """Shared bytes of each loop group's mask (one byte a point)."""
        return [_align16((tile[0] + e.i[1] - e.i[0]) * (tile[1] + e.j[1] - e.j[0]))
                for _, e in self.loops.values()]


def _hoist_bytes(st: ir.Stencil, hoisted, tile: Tuple[int, int]) -> int:
    """Shared bytes of the hoisted reads' planes at ``tile``."""
    return sum(_align16((tile[0] + e.i[1] - e.i[0]) * (tile[1] + e.j[1] - e.j[0])
                        * _value_size(st.decl(r.name).dtype)) for r, e, _ in hoisted)


def _covers(outer: Extent, inner: Extent) -> bool:
    return (outer.i[0] <= inner.i[0] and inner.i[1] <= outer.i[1]
            and outer.j[0] <= inner.j[0] and inner.j[1] <= outer.j[1])


def _levels_disjoint(a, dk: int, b) -> bool:
    """No level of the interval ``a`` shifted by ``dk`` lies in the
    interval ``b``, at any depth (bounds relative to one end compare; a
    runtime bound or bounds relative to different ends may meet)."""
    def below(x, xo: int, y) -> bool:  # x + xo <= y at every depth
        return isinstance(x, ir.AxisBound) and isinstance(y, ir.AxisBound) and \
            x.level == y.level and x.offset + xo <= y.offset

    return below(a.end, dk, b.start) or below(b.end, -dk, a.start)


def _widen_writers(analysis: StencilAnalysis, secs, ring_reads, written, behind: int,
                   loop: str, plane_ext: Dict[str, Extent],
                   mirror: Dict[str, int], widened=None) -> Dict[int, Extent]:
    """Grow the rectangle of every writer of a field read at an earlier
    level so that it covers the points the read reaches (queue 3, fault 1
    of the plane-sweep form): the CTA then computes those values into its
    own ring from inputs at the same level, as it recomputes a stage's
    halo.  A widened writer may read only fields the loop does not write,
    and its own field at an earlier level (whose points join the ring
    reads, ``plane_ext`` and ``mirror`` growing with them); the rectangle
    stays inside the field's allocated extent.  ``ring_reads``: (field,
    points, reading section, K offset); a writer in a section none of whose
    levels the read reaches is left as it is.  ``_Decline`` names what
    cannot be widened.  ``widened``: rectangles grown already (by
    ``_widen_before_loops``)."""
    ext = analysis.extents
    intervals = [sec.interval for lp in analysis.stencil.vertical_loops for sec in lp.sections]
    widened = {} if widened is None else widened
    work = list(ring_reads)
    while work:
        name, at, rsid, dk = work.pop()
        for wsid, body in secs:
            if _levels_disjoint(intervals[rsid], dk, intervals[wsid]):
                continue
            for s in body:
                targets = {w.name for w in _stmt_writes(s)}
                if name not in targets:
                    continue
                we = widened.get(id(s)) or ext.stmt_extent(s)
                if _covers(we, at):
                    continue
                grown = Extent(i=(min(we.i[0], at.i[0]), max(we.i[1], at.i[1])),
                               j=(min(we.j[0], at.j[0]), max(we.j[1], at.j[1])))
                if targets != {name} or not _covers(ext.alloc_extent(name), grown):
                    raise _Decline(
                        f"cuda backend: '{name}' is read at an earlier level, at points "
                        f"I{at.i} J{at.j} its writer in the {loop} loop does not compute "
                        f"(I{we.i} J{we.j}), and the writer cannot be widened there")
                for r in _stmt_reads(s):
                    if r.name not in written:
                        continue
                    cart = isinstance(r.offset, ir.CartesianOffset)
                    if r.name != name or not cart or r.offset.k * behind <= 0:
                        raise _Decline(
                            f"cuda backend: '{name}' is read at an earlier level at points its "
                            f"writer in the {loop} loop does not compute, and that writer reads "
                            f"'{r.name}', which the loop writes, where another CTA computes it")
                    at2 = grown + Extent.from_offset(r.offset.i, r.offset.j)
                    plane_ext[name] = plane_ext[name] | at2
                    mirror[name] = max(mirror.get(name, 1), abs(r.offset.k) + 1)
                    work.append((name, at2, wsid, r.offset.k))
                plane_ext[name] = plane_ext[name] | grown
                widened[id(s)] = grown
    return widened


@dataclass
class WindowPlan:
    """K4's window of a column-form loop: the fields it reads and does not
    write, staged per K block, as (name, rows, columns, K halo levels,
    value bytes, offset hull); ``lanes[n]``: the elements of array n one
    16-byte ``cp.async`` copies (0: the array's values are converted from a
    narrower storage type and loaded synchronously).  A slot holds one
    block's window, rows padded to whole 16-byte words; the ring holds
    ``slots`` of them."""

    arrays: List[Tuple[str, int, int, int, int, Extent]]
    lanes: List[int] = field(default_factory=list)
    slots: int = KB_SLOTS

    def pitch(self, n: int) -> int:
        """Elements between the rows of array ``n`` in shared memory."""
        nj, lanes = self.arrays[n][2], self.lanes[n]
        return -(-nj // lanes) * lanes if lanes else nj

    def array_bytes(self, n: int, kb: int) -> int:
        _, ni, _, kh, size, _ = self.arrays[n]
        return _align16(ni * self.pitch(n) * (kb + kh) * size)

    def slot_bytes(self, kb: int) -> int:
        return sum(self.array_bytes(n, kb) for n in range(len(self.arrays)))

    def smem_bytes(self, kb: int) -> int:
        return max(16, self.slots * self.slot_bytes(kb))

    def choose_kb(self, dK: int) -> Optional[int]:
        """The largest of (dK, 512, 256, ..., 8) whose ring leaves
        ``KB_CTAS_PER_SM`` CTAs on a SM; where even 8 levels leave fewer,
        the largest whose ring fits one CTA (None: none fits)."""
        cands = (dK,) + tuple(k for k in KB_CANDIDATES if k < dK)
        for budget in (KB_SMEM_BUDGET, SMEM_MAX):
            for kb in cands:
                if self.smem_bytes(kb) <= budget:
                    return kb
        return None


@dataclass
class VectorPlan:
    """The vector kernel of a row-form stage (K6 on Hopper): each thread
    computes ``V`` consecutive J points, ``V`` = 16 bytes over the smallest
    item size of the J-contiguous fields the stage reaches in device memory
    (``fields``).  A read-only field's reads come from register windows of
    aligned 16-byte words, one per (field, I offset, K offset) row:
    ``windows[key]`` = (lowest element relative to the group, elements),
    ``need[key]`` = the rows (I) and elements (J) its readers reach, as
    extents of the domain.  A field the stage writes lives in a register
    array ``o_<name>[V]``, loaded first over ``preload[name]`` (absent when
    an unconditional write of the whole access hull comes first) and stored
    over ``stores[name]``, its writers' hull."""

    V: int
    fields: List[str]
    windows: Dict[Tuple[str, int, int], Tuple[int, int]]
    need: Dict[Tuple[str, int, int], Extent]
    outputs: List[str]
    preload: Dict[str, Extent]
    stores: Dict[str, Extent]
    #: section id -> the windows its statements read (loaded at its levels)
    reads: Dict[int, List[Tuple[str, int, int]]] = field(default_factory=dict)


@dataclass
class VarkPlan:
    """The staged form (K3 on Hopper) of a row-form stage that reads fields
    at a variable K: one CTA of ``tile`` columns times ``lanes`` levels
    marches the stage's levels, ``lanes`` a step; each field of ``fields``
    -- (name, pitch, lanes16, value bytes) -- keeps its levels for the
    CTA's columns in a shared-memory window of S levels (S set at launch,
    ``_vark_slots``), each window row staged from its aligned-down 16-byte
    word (``lanes16`` elements a copy; 0: the values are converted and
    loaded synchronously), ``pitch`` elements a row."""

    tile: Tuple[int, int]
    lanes: int
    fields: List[Tuple[str, int, int, int]]

    def level_bytes(self, n: int) -> int:
        """Bytes one level of field ``n``'s window takes."""
        _, pitch, _, size = self.fields[n]
        return self.tile[0] * pitch * size

    def window_bytes(self, slots: Sequence[int]) -> int:
        return max(16, sum(_align16(s * self.level_bytes(n)) for n, s in enumerate(slots)))

    def record(self, name: str) -> dict:
        return {"kernel": name, "tile": list(self.tile), "lanes": self.lanes,
                "threads": self.tile[0] * self.tile[1] * self.lanes,
                "fields": [n for n, *_ in self.fields]}


def _vark_slots(vp: VarkPlan, levels: Sequence[int]) -> List[int]:
    """Each window's levels for buffers of ``levels`` levels: all of them
    (the whole column) when every window fits ``VK_BUDGET``, else one ring
    depth S for all, the most the budget holds (at least ``VK_MIN_RING``),
    a field with fewer levels keeping its whole column."""
    per = [vp.level_bytes(n) for n in range(len(vp.fields))]
    if sum(_align16(n * b) for n, b in zip(levels, per)) <= VK_BUDGET:
        return list(levels)
    ring = max(VK_MIN_RING, VK_BUDGET // sum(per))
    return [min(n, ring) for n in levels]


@dataclass
class KernelPlan:
    """One ``__global__`` kernel: a row-form stage (or its staged form), a
    column-form loop, a plane-sweep loop, a PARALLEL section's tile kernel
    or a run of serial loops' fused column kernel."""

    name: str
    form: str  # "rows" | "vark" | "columns" | "planes" | "tile" | "column" | "sweep"
    order: ir.LoopOrder
    #: (global section index, statements) in execution order
    sections: List[Tuple[int, List[ir.Stmt]]]
    rect: Extent = field(default_factory=Extent)
    reads: List[str] = field(default_factory=list)
    writes: List[str] = field(default_factory=list)
    planes: Optional[PlanePlan] = None
    #: the K-window variant K4 launches (column form only)
    window: Optional[WindowPlan] = None
    #: the vector variant (row form only, when a J-contiguous field exists)
    vector: Optional[VectorPlan] = None
    #: the staged form's plan (form "vark")
    vark: Optional[VarkPlan] = None
    #: the tile form's plan (form "tile")
    tile: Optional["TilePlan"] = None
    #: the fused column kernel's loops (form "column")
    group: Optional["ColumnGroup"] = None
    #: a column loop whose one-pass kernel the fused kernel replaces: it is
    #: launched only as K4's window kernel
    k4_only: bool = False
    #: the sweep form's plan (form "sweep": the plane kernel ``planes`` and
    #: the fused column kernel ``group`` in one)
    sweep: Optional[SweepPlan] = None
    #: the index of the sweep kernel that replaces this plane kernel or
    #: fused column kernel where it runs (they run under K4, and where the
    #: sweep cannot order a call's sections)
    swept_by: Optional[int] = None


def _split_stages(stmts: List[ir.Stmt]) -> List[List[ir.Stmt]]:
    """Row-form stages of one PARALLEL section (see module docstring).
    A compound statement (``if``, ``while``, a region) is one unit."""
    stages: List[List[ir.Stmt]] = []
    cur: List[ir.Stmt] = []
    written: set = set()
    offset_read: set = set()
    for stmt in stmts:
        reads = _stmt_reads(stmt)
        writes = {w.name for w in _stmt_writes(stmt)}
        if not isinstance(stmt, ir.Assign) and any(
            r.name in writes and _nonzero(r.offset) for r in reads
        ):
            raise NotImplementedError(
                "cuda backend: a compound statement reads a field it writes at an offset"
            )
        hazard = any(r.name in written and _nonzero(r.offset) for r in reads) or (
            writes & offset_read
        )
        if hazard and cur:
            stages.append(cur)
            cur, written, offset_read = [], set(), set()
        cur.append(stmt)
        written |= writes
        offset_read |= {r.name for r in reads if _nonzero(r.offset)}
    if cur:
        stages.append(cur)
    return stages


def _k_invariant(st: ir.Stencil, e: ir.Expr) -> bool:
    """``e`` has one value along K in a column: literals, scalars, the I
    and J positions and fields without a K axis read at the point, and
    arithmetic of those."""
    for node in ir.walk_values(e):
        if isinstance(node, ir.FieldAccess):
            if st.decl(node.name).dimensions[2] or node.data_index or not isinstance(
                    node.offset, ir.CartesianOffset):
                return False
        elif isinstance(node, ir.AxisPosition) and node.axis == "K":
            return False
    return True


def _hoistable(st: ir.Stencil, stmts: Sequence[ir.Stmt], written) -> List[ir.FieldAccess]:
    """The reads of ``stmts`` at an absolute K whose index (and data index)
    does not vary along K, of fields not in ``written``: one load a column
    serves every level.  A field the kernel writes keeps its reads in the
    K loop, where they see the writes."""
    out = []
    for s in stmts:
        for r in _stmt_reads(s):
            if isinstance(r.offset, ir.AbsoluteKIndex) and r.name not in written \
                    and _k_invariant(st, r.offset.k) \
                    and all(_k_invariant(st, d) for d in r.data_index):
                out.append(r)
    return out


def _hoist_extents(ext, stmts: Sequence[ir.Stmt], reads, extent=None) -> Dict[int, Extent]:
    """Each hoisted read (by ``id``) -> the union of the extents of the
    top-level statements that hold it (``extent(s)``: a statement's
    rectangle, its extent by default)."""
    ids = {id(r) for r in reads}
    out: Dict[int, Extent] = {}
    for s in stmts:
        e = extent(s) if extent else ext.stmt_extent(s)
        e = Extent(i=e.i, j=e.j)
        for r in _stmt_reads(s):
            if id(r) in ids:
                out[id(r)] = out.get(id(r), e) | e
    return out


def _vark_plan(st: ir.Stencil, stmts: List[ir.Stmt], written_by_stencil) -> VarkPlan:
    """The staged form of a row-form stage, or ``_Decline``: it stages the
    fields the stage reads at a variable K that are 3-D, without data
    dimensions, and that the stencil does not write (a field written by
    any of its kernels is read from device memory)."""
    names, why = [], None
    for s in stmts:
        for r in _stmt_reads(s):
            if not isinstance(r.offset, ir.VariableKOffset) or r.name in names:
                continue
            decl = st.decl(r.name)
            if r.name in written_by_stencil:
                why = why or f"'{r.name}' is written by the stencil"
            elif r.name not in st.field_decls:
                why = why or f"'{r.name}' is a temporary"
            elif decl.data_dims or not all(decl.dimensions):
                why = why or f"'{r.name}' has data dimensions or lacks an I, J or K axis"
            else:
                names.append(r.name)
    if not names:
        raise _Decline("cuda backend: the staged form stages a 3-D field the stencil only reads, "
                       "read at a variable K; " + (why or "the stage reads none at a variable K"))
    TI, TJ = VK_TILE
    fields = []
    for n in names:
        dt = np.dtype(st.decl(n).dtype)
        size = _value_size(dt)
        lanes = 16 // size if dt.itemsize == size and size in (4, 8) else 0
        pitch = -(-(TJ + lanes - 1) // lanes) * lanes if lanes else TJ
        fields.append((n, pitch, lanes, size))
    vp = VarkPlan(tile=VK_TILE, lanes=VK_LANES, fields=fields)
    if vp.window_bytes([VK_MIN_RING] * len(fields)) > SMEM_MAX:
        raise _Decline(f"cuda backend: the staged form's windows need more than {SMEM_MAX} "
                       f"bytes at a ring of {VK_MIN_RING} levels")
    return vp


def _loop_group(st: ir.Stencil, w: ir.While):
    """``(body stages, (I reach, J reach))`` of a ``while`` that reads at a
    horizontal offset a field it writes, for the plane form to run one
    iteration at a time by the whole CTA, over the loop's extent grown by
    the reach: exact where a point's iteration needs its neighbours' values
    of the same iteration only through fields whose values at a point
    depend on the loop's fields at that point alone (a neighbour's value
    then never needs its own neighbours').  ``_Decline`` otherwise, and
    where such a field is an API field or is read at a K offset, or the
    body holds a loop."""
    writes = {x.name for x in _stmt_writes(w)}
    reach = [0, 0]
    deps = {r.name for r in ir.field_accesses(w.cond) if r.name in writes}
    if any(r.name in writes and _ij(r.offset) for r in ir.field_accesses(w.cond)):
        raise _Decline("cuda backend: a while condition reads at a horizontal offset a field "
                       "its loop writes")
    for r in _stmt_reads(w):
        if r.name not in writes:
            continue
        if not isinstance(r.offset, ir.CartesianOffset) or r.offset.k:
            raise _Decline(f"cuda backend: a while loop reads '{r.name}', which it writes, "
                           "at a K offset or a variable level")
        if _ij(r.offset):
            deps.add(r.name)
            reach = [max(reach[0], abs(r.offset.i)), max(reach[1], abs(r.offset.j))]
    for n in sorted(deps):
        if n in st.field_decls:
            raise _Decline(f"cuda backend: a while loop reads the API field '{n}', which it "
                           "writes, at a horizontal offset")
    grown = True
    while grown:
        grown = False
        for b in w.body:
            if any(isinstance(x, ir.While) for x in ir.walk_values(b)):
                raise _Decline("cuda backend: a while loop that reads at a horizontal offset a "
                               "field it writes holds a loop")
            if not {x.name for x in _stmt_writes(b)} & deps:
                continue
            for r in _stmt_reads(b):
                if r.name in writes and _ij(r.offset):
                    raise _Decline(
                        f"cuda backend: a while loop reads '{r.name}' at a horizontal offset "
                        "where a neighbour's value would need its own neighbours'")
                if r.name in writes and r.name not in deps:
                    deps.add(r.name)
                    grown = True
    return _plane_stages(list(w.body)), tuple(reach)


def _plane_stages(stmts: List[ir.Stmt], loops: Optional[dict] = None,
                  st: Optional[ir.Stencil] = None) -> List[List[ir.Stmt]]:
    """The stages of one plane: a new stage starts at a read, at a
    horizontal offset, of a field written earlier in the stage, and at a
    write of a field the stage read so.  K offsets start none (the plane's
    other levels are checked by ``_plan_planes``).  ``loops`` (the plane
    form of a serial loop): a ``while`` that reads at a horizontal offset a
    field it writes is a stage of its own, its ``_loop_group`` recorded
    there by ``id``."""
    stages: List[List[ir.Stmt]] = []
    cur: List[ir.Stmt] = []
    written: set = set()
    offset_read: set = set()
    for stmt in stmts:
        writes = {w.name for w in _stmt_writes(stmt)}
        ij = {r.name for r in _stmt_reads(stmt) if _ij(r.offset)}
        if not isinstance(stmt, ir.Assign) and writes & ij:
            if loops is None or not isinstance(stmt, ir.While):
                raise _Decline(
                    "cuda backend: a compound statement reads at a horizontal offset a field "
                    f"it writes ({sorted(writes & ij)})"
                )
            loops[id(stmt)] = _loop_group(st, stmt)
            if cur:
                stages.append(cur)
            stages.append([stmt])
            cur, written, offset_read = [], set(), set()
            continue
        if cur and (ij & written or writes & offset_read):
            stages.append(cur)
            cur, written, offset_read = [], set(), set()
        cur.append(stmt)
        written |= writes
        offset_read |= ij
    if cur:
        stages.append(cur)
    return stages


def _widen_before_loops(analysis: StencilAnalysis, stages, loops, written: set,
                        loop: str) -> Dict[int, Extent]:
    """Grow the rectangle of every statement that writes, earlier in the
    level, a field a CTA-iterated ``while`` (``_loop_group``) reads at the
    level, to the loop's rectangle plus the read's offset (queue 3, seeds
    147 and 386): the CTA then computes those values into the field's plane
    for the points the loop reads, as the plane form widens ring writers.
    The statements those writers read, earlier in the level, grow in turn.
    A widened statement computes only its own extent in the domain and
    writes device memory only where the CTA owns the point.  ``_Decline``
    where a writer is itself such a loop, or reads an API field the loop
    writes."""
    ext = analysis.extents
    st = analysis.stencil
    grown: Dict[int, Extent] = {}
    for sts in stages.values():
        flat = [s for stage in sts for s in stage]
        work = []
        for pos, s in enumerate(flat):
            if id(s) in loops:
                q = loops[id(s)][1]
                work += [(r.name, q + Extent.from_offset(r.offset.i, r.offset.j), pos)
                         for r in _stmt_reads(s)
                         if isinstance(r.offset, ir.CartesianOffset) and not r.offset.k]
        while work:
            name, at, upto = work.pop()
            for pos in range(upto):
                w = flat[pos]
                if name not in {x.name for x in _stmt_writes(w)}:
                    continue
                cur = grown.get(id(w)) or ext.stmt_extent(w)
                cur = Extent(i=cur.i, j=cur.j)
                if _covers(cur, at):
                    continue
                if id(w) in loops:
                    raise _Decline(f"cuda backend: a while loop iterated by the CTA reads "
                                   f"'{name}' where the loop before it in the {loop} loop, "
                                   "which writes it, does not compute it")
                for r in _stmt_reads(w):
                    if r.name in written and r.name in st.field_decls:
                        raise _Decline(
                            f"cuda backend: a while loop iterated by the CTA reads '{name}', "
                            f"whose writer before it in the {loop} loop reads the API field "
                            f"'{r.name}', which the loop writes")
                new = cur | at
                grown[id(w)] = new
                work += [(r.name, new + Extent.from_offset(r.offset.i, r.offset.j), pos)
                         for r in _stmt_reads(w)
                         if isinstance(r.offset, ir.CartesianOffset) and not r.offset.k]
    return grown


def _plan_planes(analysis: StencilAnalysis, order: ir.LoopOrder,
                 secs: List[Tuple[int, List[ir.Stmt]]], plane_temps,
                 choose_tile: bool = True, per_level: Optional[str] = None,
                 loop_groups: Optional[bool] = None) -> PlanePlan:
    """The plane-sweep form of a serial loop, or ``_Decline`` naming the
    read it cannot order.  A point is *owned* by the CTA whose tile holds
    it (tiles at the domain's edge own the halo beyond it); a read of a
    field the loop writes, at another level or before the plane's write,
    must stay on owned points: another CTA may write the others at any
    time.  ``choose_tile=False`` (the tile form, which chooses its own
    tile): no tile is chosen here.  ``loop_groups``: a ``while`` that reads
    at a horizontal offset a field it writes is iterated by the CTA
    (``_loop_group``; by default in the plane form of a serial loop, and
    the tile form asks for it)."""
    st = analysis.stencil
    ext = analysis.extents
    loop = order.name
    # the plane form of a serial loop and the tile form run a while loop
    # with horizontal self-reads one iteration at a time (``_loop_group``)
    if loop_groups is None:
        loop_groups = choose_tile and order != ir.LoopOrder.PARALLEL
    groups: Optional[dict] = {} if loop_groups else None
    stages = {sid: _plane_stages(body, groups, st) for sid, body in secs}
    by_id = {id(x): x for _, body in secs for x in body}
    loops: Dict[int, Tuple[List[List[ir.Stmt]], Extent]] = {}
    for k, (stg, (ri, rj)) in (groups or {}).items():
        e = ext.stmt_extent(by_id[k])
        loops[k] = (stg, Extent(i=(e.i[0] - ri, e.i[1] + ri), j=(e.j[0] - rj, e.j[1] + rj)))
    in_loops = {n for _, body in secs for x in body if id(x) in loops
                for n in {a.name for a in ir.field_accesses(x)}}
    for _, body in secs:
        for x in body:
            carried = {w.name for w in _stmt_writes(x)} & {r.name for r in _stmt_reads(x)}
            if id(x) in loops and carried & set(plane_temps):
                # their values from before the loop exist only where an earlier
                # statement of the level computed them, not over the loop's rectangle
                raise _Decline(f"cuda backend: a while loop iterated by the CTA carries the "
                               f"plane-local {sorted(carried & set(plane_temps))}")
    written = {w.name for _, body in secs for s in body for w in _stmt_writes(s)}
    pre = _widen_before_loops(analysis, stages, loops, written, loop) if loops else {}
    for _, body in secs:
        for s in body:
            for w in _stmt_writes(s):
                if not isinstance(w.offset, ir.CartesianOffset) or w.offset.k:
                    raise _Decline(f"cuda backend: '{w.name}' is written at a K offset in the "
                                   f"{loop} loop")
    touched: Dict[str, Dict[int, set]] = {}
    plane_ext: Dict[str, Extent] = {}
    off_read: set = set()
    mirror: Dict[str, int] = {}
    snapshots: Dict[int, str] = {}
    primed: Dict[int, List[str]] = {}
    ring_reads: List[Tuple[str, Extent, int, int]] = []
    behind = -1 if order == ir.LoopOrder.FORWARD else 1
    for sid, sts in stages.items():
        flat = [(n, s) for n, stage in enumerate(sts) for s in stage]
        # the names written at or after each position
        after = [set()]
        for _, s2 in reversed(flat):
            after.append(after[-1] | {w.name for w in _stmt_writes(s2)})
        after.reverse()
        before: set = set()
        for pos, (n, s) in enumerate(flat):
            e = loops[id(s)][1] if id(s) in loops else pre.get(id(s)) or ext.stmt_extent(s)
            e = Extent(i=e.i, j=e.j)
            later = after[pos]
            for w in _stmt_writes(s):
                touched.setdefault(w.name, {}).setdefault(sid, set()).add(n)
                plane_ext[w.name] = plane_ext.get(w.name, e) | e
            for r in _stmt_reads(s):
                touched.setdefault(r.name, {}).setdefault(sid, set()).add(n)
                cart = isinstance(r.offset, ir.CartesianOffset)
                if cart and not r.offset.k:
                    at = e + Extent.from_offset(r.offset.i, r.offset.j)
                    plane_ext[r.name] = plane_ext.get(r.name, at) | at
                if _nonzero(r.offset):
                    off_read.add(r.name)
                if r.name not in written or r.name in plane_temps:
                    continue
                unowned = _ij(r.offset) or e != Extent()
                if not unowned:
                    continue
                if not cart:
                    raise _Decline(
                        f"cuda backend: '{r.name}' is read at a variable level, at points "
                        f"another CTA writes, in the {loop} loop that writes it")
                if not isinstance(s, ir.Assign) and (not _nonzero(r.offset) or (
                        id(s) in loops and not r.offset.k)) and \
                        r.name not in before and r.name in {w.name for w in _stmt_writes(s)}:
                    # a compound statement's reads at the point of a field it
                    # writes see its own writes there (a ``while`` condition
                    # after an iteration): the shared plane, primed from
                    # the snapshot (the value from before the loop)
                    if r.name not in primed.setdefault(id(s), []):
                        primed[id(s)].append(r.name)
                    mirror.setdefault(r.name, 1)
                    continue
                if r.offset.k * behind < 0 or (not r.offset.k and r.name not in before
                                                and r.name in later):
                    # a value the sweep has not written yet: the one from
                    # before the loop, in a copy taken before the kernel
                    snapshots[id(r)] = r.name
                elif r.offset.k and per_level:
                    # an earlier plane, written by the launches before
                    continue
                elif r.offset.k:
                    # an earlier plane: from the CTA's own ring of planes
                    at = e + Extent.from_offset(r.offset.i, r.offset.j)
                    plane_ext[r.name] = plane_ext.get(r.name, at) | at
                    mirror[r.name] = max(mirror.get(r.name, 1), abs(r.offset.k) + 1)
                    ring_reads.append((r.name, at, sid, r.offset.k))
                elif r.name in before:
                    mirror.setdefault(r.name, 1)
            before |= {w.name for w in _stmt_writes(s)}
    # the ring holds what the CTA computed: every writer must cover the
    # points read from it, widened where it does not
    try:
        widened = _widen_writers(analysis, secs, ring_reads, written, behind, loop,
                                 plane_ext, mirror, dict(pre))
    except _Decline as e:
        intervals = [sec.interval for lp in st.vertical_loops for sec in lp.sections]
        ordered = all(_levels_disjoint(intervals[a], 0, intervals[b])
                      for a, _ in secs for b, _ in secs if a < b)
        if not choose_tile or not ordered:
            raise
        return _plan_planes(analysis, order, secs, plane_temps, per_level=str(e))
    widened_fields: Dict[str, Extent] = {}
    for _, body in secs:
        for s in body:
            if id(s) in widened:
                for w in {w.name for w in _stmt_writes(s)}:
                    widened_fields[w] = widened_fields.get(w, widened[id(s)]) | widened[id(s)]
    local = [n for n in touched if n in plane_temps]
    registers = [n for n in local if n not in off_read and n not in in_loops
                 and all(len(v) == 1 for v in touched[n].values())]
    shared = {n: plane_ext[n] for n in local if n not in registers}
    snapshot_names = set(snapshots.values()) | {n for ns in primed.values() for n in ns}
    for n in sorted(mirror) + sorted(snapshot_names):
        decl = st.decl(n)
        if decl.data_dims or not (decl.dimensions[0] and decl.dimensions[1]):
            raise _Decline(f"cuda backend: '{n}' (data dimensions or no I/J axis) is read at "
                           f"a horizontal offset in the {loop} loop that writes it")
    for n in sorted(mirror):
        shared[n] = plane_ext[n]

    stmts = [s for _, body in secs for s in body]
    hoist = _hoistable(st, stmts, written)
    rects = _hoist_extents(ext, stmts, hoist, lambda s: loops[id(s)][1] if id(s) in loops
                           else widened.get(id(s)) or ext.stmt_extent(s))
    doms = _hoist_extents(ext, stmts, hoist)
    hoisted = [(r, rects[id(r)], doms[id(r)]) for r in hoist]

    def nbytes(tile):
        return sum(_align16((tile[0] + e.i[1] - e.i[0]) * (tile[1] + e.j[1] - e.j[0])
                            * _value_size(st.decl(n).dtype) * mirror.get(n, 1))
                   for n, e in shared.items()) + _hoist_bytes(st, hoisted, tile) + sum(
            _align16((tile[0] + e.i[1] - e.i[0]) * (tile[1] + e.j[1] - e.j[0]))
            for _, e in loops.values())

    fits = [t for t in PLANE_TILES if nbytes(t) <= SMEM_MAX] if choose_tile else PLANE_TILES
    if not fits:
        raise _Decline(f"cuda backend: the {loop} loop's shared planes need "
                       f"{nbytes(PLANE_TILES[-1])} bytes at a {PLANE_TILES[-1]} tile")
    tile = fits[0]
    return PlanePlan(tile=tile, stages=stages, shared=shared,
                     mirrored={n: mirror[n] for n in sorted(mirror)},
                     registers=registers, smem_bytes=max(16, nbytes(tile)),
                     snapshots=sorted(snapshot_names),
                     snapshot_reads=frozenset(snapshots),
                     widened=widened, widened_fields=widened_fields, hoisted=hoisted,
                     primed=primed, loops=loops, per_level=per_level)


def _ij_hazard(loop: ir.VerticalLoop) -> bool:
    """The loop reads, at a horizontal offset, a field it writes."""
    written = {w.name for s in loop.sections for st_ in s.body for w in _stmt_writes(st_)}
    return any(r.name in written and _ij(r.offset)
               for s in loop.sections for st_ in s.body for r in _stmt_reads(st_))


@dataclass
class TilePlan:
    """The tile form of one PARALLEL section (K1 on Hopper): one CTA per
    (TI x TJ) tile and ``kz`` levels; ``planes`` is ``_plan_planes``' plan
    of the section (its stages, shared planes, registers, snapshots).
    A shared plane lives in ``slot[name]`` of ``slot_bytes`` (planes whose
    stages do not overlap share a slot); each staged input -- a field the
    section reads at a horizontal offset and does not write -- is copied
    into a ring of two slots per level, as (name, K offset, extent, pitch,
    lanes: elements a 16-byte copy moves, 0 for loads that convert)."""

    tile: Tuple[int, int]
    kz: int
    planes: PlanePlan
    slot: Dict[str, int]
    slot_bytes: List[int]
    inputs: List[Tuple[str, int, Extent, int, int]]
    input_bytes: int
    smem_bytes: int
    ctas_per_sm: int
    #: points computed over points owned, over the section's statements
    halo: float

    def record(self, name: str) -> dict:
        return {"kernel": name, "tile": list(self.tile), "kz": self.kz,
                "slots": len(self.slot_bytes), "planes": len(self.slot),
                "smem_bytes": self.smem_bytes, "ctas_per_sm": self.ctas_per_sm,
                "halo": round(self.halo, 4), "staged": [f"{n}@k{dk}" for n, dk, *_ in self.inputs]}


@dataclass
class SweepPlan:
    """The sweep form (K5 on Hopper) of a serialized PARALLEL loop and the
    run of serial loops after it: one CTA per (TI x TJ) tile, one thread
    per column (``threads`` = TI TJ), sweeping K once.  At step k the
    plane part (the PARALLEL loop's stages, ``_plane_level``) computes
    level k + ``lead`` and the first column loop level k; the values the
    column loops read of fields the plane part writes, at the CTA's own
    points, stay in a shared ring of ``ring[name]`` levels.  The later
    loops run after the sweep in the same CTA, as the fused column kernel
    runs them.  The plane part's shared planes are in slots by liveness
    (``slot``, ``slot_bytes``); its ``inputs`` (read at a horizontal
    offset, with one PARALLEL section) are staged a level ahead into a
    two-slot ring as the tile form stages them."""

    tile: Tuple[int, int]
    threads: int
    lead: int
    ring: Dict[str, int]
    slot: Dict[str, int]
    slot_bytes: List[int]
    inputs: List[Tuple[str, int, Extent, int, int]]
    input_bytes: int
    smem_bytes: int
    ctas_per_sm: int
    #: plane points computed over points owned, over the plane part's
    #: statements
    halo: float
    #: the plane part's sections and the first column loop's (global
    #: indices), whose K ranges a call must give in order
    plane_secs: List[int] = field(default_factory=list)
    col_secs: List[int] = field(default_factory=list)

    def ordered(self, kb: Sequence[Tuple[int, int]]) -> bool:
        """The sweep can run a call with section bounds ``kb``: within the
        plane part and within the first column loop, the sections that
        sweep any level follow one another along K (then interleaving them
        level by level keeps their order)."""
        for secs in (self.plane_secs, self.col_secs):
            ranges = [kb[sid] for sid in secs if kb[sid][0] < kb[sid][1]]
            if any(a[1] > b[0] for a, b in zip(ranges, ranges[1:])):
                return False
        return True

    def record(self, name: str) -> dict:
        return {"kernel": name, "tile": list(self.tile), "threads": self.threads,
                "lead": self.lead, "ring": dict(self.ring), "slots": len(self.slot_bytes),
                "planes": len(self.slot), "smem_bytes": self.smem_bytes,
                "ctas_per_sm": self.ctas_per_sm, "halo": round(self.halo, 4),
                "staged": [f"{n}@k{dk}" for n, dk, *_ in self.inputs]}


@dataclass
class ColumnGroup:
    """The fused column kernel (K2 on Hopper) of consecutive serial loops:
    ``loops`` their orders and sections (their per-loop column kernels run
    only under K4, ``KernelPlan.k4_only``).  Set by ``generate``:
    ``carries`` (temporaries read only at the level before, in the loop
    that writes them: two registers), ``columns`` (also read by a later
    loop of the group: registers, and one store per level in device
    memory), ``writer`` (temporary -> its loop's index in
    ``loops``), ``prefetch`` (section -> the reads of inputs loaded one
    level ahead)."""

    loops: List[Tuple[ir.LoopOrder, List[Tuple[int, List[ir.Stmt]]]]]
    carries: List[str] = field(default_factory=list)
    columns: List[str] = field(default_factory=list)
    writer: Dict[str, int] = field(default_factory=dict)
    prefetch: Dict[int, List[Tuple[str, int, int, int]]] = field(default_factory=dict)


def _touching_sections(st: ir.Stencil) -> Dict[str, set]:
    """Name -> the sections (by global index) that access it."""
    out: Dict[str, set] = {}
    sid = 0
    for loop in st.vertical_loops:
        for sec in loop.sections:
            for s in sec.body:
                for node in ir.walk_values(s):
                    if isinstance(node, ir.FieldAccess):
                        out.setdefault(node.name, set()).add(sid)
            sid += 1
    return out


def _section_local_temps(st: ir.Stencil, sid: int, body: List[ir.Stmt],
                         touching: Dict[str, set]) -> frozenset:
    """Temporaries the tile form keeps on chip in one PARALLEL section:
    accessed in no other section, at no K offset, without data
    dimensions, and written first by an unconditional statement that does
    not read them (so a shared slot's earlier content is never seen)."""
    out = set()
    # one walk of the body: the names accessed at a K offset or a variable
    # level, and the first statement that accesses each name
    k_read, first = set(), {}
    for s in body:
        for node in ir.walk_values(s):
            if isinstance(node, ir.FieldAccess):
                first.setdefault(node.name, s)
                if not isinstance(node.offset, ir.CartesianOffset) or node.offset.k:
                    k_read.add(node.name)
    for name, decl in st.temp_decls.items():
        if decl.data_dims or touching.get(name) != {sid} or name in k_read:
            continue
        s = first.get(name)
        if isinstance(s, ir.Assign) and s.target.name == name and not any(
                r.name == name for r in _stmt_reads(s)):
            out.add(name)
    return frozenset(out)


def _assign_slots(live: Dict[str, Tuple[int, int]], size: Dict[str, int]):
    """Shared planes into slots by liveness: planes taken by first stage,
    each into the free slot (its last plane's stages ended before this
    plane's first) that fits it best, a slot growing to its largest plane.
    Returns (plane -> slot, slot bytes)."""
    slots: List[List[int]] = []  # [bytes, last stage]
    where: Dict[str, int] = {}
    for name in sorted(live, key=lambda n: (live[n][0], -size[n], n)):
        first, last = live[name]
        free = [n for n, (_, end) in enumerate(slots) if end < first]
        fit = [n for n in free if slots[n][0] >= size[name]]
        if fit:
            n = min(fit, key=lambda x: slots[x][0])
        elif free:
            n = max(free, key=lambda x: slots[x][0])
        else:
            slots.append([0, -2])
            n = len(slots) - 1
        slots[n] = [max(slots[n][0], size[name]), last]
        where[name] = n
    return where, [b for b, _ in slots]


def _plan_tile(analysis: StencilAnalysis, sid: int, body: List[ir.Stmt],
               local) -> TilePlan:
    """The tile form of one PARALLEL section, or ``_Decline`` naming why
    it cannot run (see the module docstring)."""
    st = analysis.stencil
    ext = analysis.extents
    written = {w.name for s in body for w in _stmt_writes(s)}
    for s in body:
        for r in _stmt_reads(s):
            if r.name in written and _nonzero(r.offset) and (
                    not isinstance(r.offset, ir.CartesianOffset) or r.offset.k):
                raise _Decline(f"cuda backend: a K-offset read of '{r.name}', which the "
                               "PARALLEL section writes (its levels run in other CTAs)")
    pp = _plan_planes(analysis, ir.LoopOrder.PARALLEL, [(sid, body)], local,
                      choose_tile=False, loop_groups=True)
    stages = pp.stages[sid]
    live = _plane_live(pp, stages)
    staged = _staged_hull(st, ext, body, written | set(local),
                          lambda s: pp.extent(analysis, s))

    def plan(tile):
        TI, TJ = tile
        size = {n: _align16((TI + e.i[1] - e.i[0]) * (TJ + e.j[1] - e.j[0])
                            * _value_size(st.decl(n).dtype)) for n, e in pp.shared.items()}
        slot, slot_bytes = _assign_slots(live, size)
        inputs = _staged_inputs(st, tile, staged)
        nin = _staging_layout(st, tile, inputs)[1]
        smem = max(16, sum(slot_bytes) + 2 * nin + _hoist_bytes(st, pp.hoisted, tile)
                   + sum(pp.mask_bytes(tile)))
        return slot, slot_bytes, inputs, nin, smem

    plans = [(tile, plan(tile)) for tile in TILE_SHAPES]
    choice = next(((tile, got) for want in (TILE_CTAS_PER_SM, TILE_CTAS_MIN, 1)
                   for tile, got in plans
                   if got[4] <= SMEM_MAX and ctas_per_sm(got[4], PLANE_THREADS) >= want), None)
    if choice is None:
        raise _Decline(f"cuda backend: the PARALLEL section's shared planes and staged "
                       f"inputs need {plan(TILE_SHAPES[-1])[4]} bytes at a "
                       f"{TILE_SHAPES[-1]} tile, above {SMEM_MAX}")
    (TI, TJ), (slot, slot_bytes, inputs, nin, smem) = choice
    pp.tile = (TI, TJ)
    pp.smem_bytes = smem
    return TilePlan(tile=(TI, TJ), kz=TILE_KZ, planes=pp, slot=slot, slot_bytes=slot_bytes,
                    inputs=inputs, input_bytes=nin, smem_bytes=smem,
                    ctas_per_sm=ctas_per_sm(smem, PLANE_THREADS),
                    halo=_halo(ext, stages, (TI, TJ)))


def _staged_inputs(st: ir.Stencil, tile: Tuple[int, int], staged):
    """The staged inputs at ``tile``: (name, K offset, extent, pitch, lanes)
    for each (name, K offset, extent) of ``staged``.  A 16-byte staged row
    holds the elements from its aligned-down word on (K6's row phase):
    ``pitch``, whole words, is one word more than the extent's width."""
    out = []
    for name, dk, e in staged:
        dt = np.dtype(st.decl(name).dtype)
        vsize = _value_size(dt)
        lanes = 16 // vsize if dt.itemsize == vsize and vsize in (4, 8) else 0
        nj = tile[1] + e.j[1] - e.j[0]
        pitch = -(-(nj + lanes - 1) // lanes) * lanes if lanes else nj
        out.append((name, dk, e, pitch, lanes))
    return out


def _staging_layout(st: ir.Stencil, tile: Tuple[int, int], inputs):
    """Each staged input's byte offset in a ring slot, and the slot's
    bytes: a 16-byte staged input's rows step by ``pitch`` plus up to
    ``lanes - 1`` elements (``_emit_staging``)."""
    out, at = [], 0
    for name, _, e, pitch, lanes in inputs:
        rows = tile[0] + e.i[1] - e.i[0]
        out.append(at)
        at += _align16((rows * (pitch + max(lanes - 1, 0)) + lanes)
                       * _value_size(st.decl(name).dtype))
    return out, at


def _staged_hull(st: ir.Stencil, ext, body: List[ir.Stmt], skip, extent=None) -> list:
    """The inputs a tile or sweep kernel stages: per (field, K offset) read
    at a horizontal offset, of the fields not in ``skip`` (written or
    on-chip), 3-D without data dimensions, the hull of what ``body``'s
    statements read (over ``extent(s)``, a statement's rectangle, its
    extent by default): [(name, K offset, extent)]."""
    hull: Dict[Tuple[str, int], Extent] = {}
    offset_read: set = set()
    for s in body:
        e = extent(s) if extent else ext.stmt_extent(s)
        for r in _stmt_reads(s):
            decl = st.decl(r.name)
            if r.name in skip or decl.data_dims or not all(decl.dimensions) \
                    or not isinstance(r.offset, ir.CartesianOffset):
                continue
            key = (r.name, r.offset.k)
            at = Extent(i=e.i, j=e.j) + Extent.from_offset(r.offset.i, r.offset.j)
            hull[key] = hull.get(key, at) | at
            if r.offset.i or r.offset.j:
                offset_read.add(key)
    return [(name, dk, hull[(name, dk)]) for name, dk in hull if (name, dk) in offset_read]


def _plane_live(pp: PlanePlan, stages: List[List[ir.Stmt]]) -> Dict[str, Tuple[int, int]]:
    """Each shared plane's stages: from its first write (a mirrored plane
    from the level's start, where it is loaded) to its last access."""
    live: Dict[str, Tuple[int, int]] = {}
    for n, stage in enumerate(stages):
        for s in stage:
            for node in ir.walk_values(s):
                if isinstance(node, ir.FieldAccess) and node.name in pp.shared:
                    a, b = live.get(node.name, (n, n))
                    live[node.name] = (min(a, n), max(b, n))
    for name in pp.mirrored:
        live[name] = (-1, live.get(name, (0, 0))[1])
    return live


def _halo(ext, stages, tile) -> float:
    """Points a CTA computes over the points it owns, over the statements."""
    TI, TJ = tile
    computed, nstmts = 0, 0
    for stage in stages:
        for s in stage:
            e = ext.stmt_extent(s)
            computed += (TI + e.i[1] - e.i[0]) * (TJ + e.j[1] - e.j[0])
            nstmts += 1
    return computed / max(1, nstmts * TI * TJ)


def _plan_sweep(analysis: StencilAnalysis, plane: KernelPlan, loops,
                plane_temps) -> Tuple[SweepPlan, PlanePlan]:
    """The sweep form (``SweepPlan``) of the serialized PARALLEL loop
    ``plane`` and the serial loops ``loops`` (order, sections) after it,
    with its plane part's ``PlanePlan`` at the sweep's tile, or
    ``_Decline`` naming what one sweep cannot order."""
    st = analysis.stencil
    ext = analysis.extents
    if loops[0][0] != plane.order:
        raise _Decline("cuda backend: the serial loop after the PARALLEL loop runs "
                       f"{loops[0][0].name}, the other way: one sweep cannot run both")
    pwrites, preads = _loop_rw(plane.sections)
    cwrites = set()
    for _, secs in loops:
        cwrites |= _loop_rw(secs)[0]
    for r in preads:
        if r.name in cwrites:
            raise _Decline(f"cuda backend: the PARALLEL loop reads '{r.name}', which a serial "
                           "loop after it writes")
    if pwrites & cwrites:
        raise _Decline(f"cuda backend: {sorted(pwrites & cwrites)} written by the PARALLEL "
                       "loop and by a serial loop after it")
    for _, secs in loops:
        for _, body in secs:
            for s in body:
                e = ext.stmt_extent(s)
                if (e.i, e.j) != ((0, 0), (0, 0)):
                    raise _Decline("cuda backend: a serial loop after the PARALLEL loop computes "
                                   f"beyond the domain (I{e.i} J{e.j}), in columns of other "
                                   "tiles")
    lead = behind = 0
    ring: set = set()
    for li, (_, secs) in enumerate(loops):
        for _, body in secs:
            for s in body:
                for r in _stmt_reads(s):
                    if r.name not in pwrites:
                        continue
                    if not isinstance(r.offset, ir.CartesianOffset):
                        raise _Decline(f"cuda backend: a serial loop reads '{r.name}', which the "
                                       "PARALLEL loop writes, at a variable K")
                    if r.offset.i or r.offset.j:
                        raise _Decline(f"cuda backend: a serial loop reads '{r.name}', which the "
                                       "PARALLEL loop writes, at a horizontal offset")
                    decl = st.decl(r.name)
                    if li == 0 and (decl.data_dims or not all(decl.dimensions)):
                        raise _Decline(f"cuda backend: the first serial loop reads '{r.name}' "
                                       "(data dimensions or no I/J/K axis), which the PARALLEL "
                                       "loop writes")
                    if li == 0:
                        ring.add(r.name)
                        lead = max(lead, r.offset.k)
                        behind = max(behind, -r.offset.k)
    depth = lead + behind + 1
    if ring and depth > SWEEP_RING_MAX:
        raise _Decline(f"cuda backend: the first serial loop reads what the PARALLEL loop "
                       f"writes {lead} levels ahead and {behind} behind: a ring of {depth} "
                       f"levels, above {SWEEP_RING_MAX}")
    for name in sorted(ring):
        for _, body in plane.sections:
            if not any(isinstance(s, ir.Assign) and s.target.name == name for s in body) or any(
                    not isinstance(s, ir.Assign) and name in {w.name for w in _stmt_writes(s)}
                    for s in body):
                raise _Decline(f"cuda backend: '{name}', which the first serial loop reads, is "
                               "not written by an unconditional statement in every section of "
                               "the PARALLEL loop")
    pp = _plan_planes(analysis, plane.order, plane.sections, plane_temps, choose_tile=False)
    if any(d > 1 for d in pp.mirrored.values()):
        raise _Decline("cuda backend: the PARALLEL loop keeps a ring of earlier planes")
    stages = [stage for sid, _ in plane.sections for stage in pp.stages[sid]]
    live = _plane_live(pp, stages)
    staged = []
    if len(plane.sections) == 1:
        staged = _staged_hull(st, ext, plane.sections[0][1], pwrites | set(plane_temps))

    def plan(tile):
        TI, TJ = tile
        size = {n: _align16((TI + e.i[1] - e.i[0]) * (TJ + e.j[1] - e.j[0])
                            * _value_size(st.decl(n).dtype)) for n, e in pp.shared.items()}
        slot, slot_bytes = _assign_slots(live, size)
        inputs = _staged_inputs(st, tile, staged)
        nin = _staging_layout(st, tile, inputs)[1]
        ring_bytes = sum(_align16(depth * TI * TJ * _value_size(st.decl(n).dtype))
                         for n in ring)
        smem = max(16, sum(slot_bytes) + 2 * nin + ring_bytes)
        return slot, slot_bytes, inputs, nin, smem

    plans = [(tile, plan(tile)) for tile in SWEEP_TILES]
    choice = next(((tile, got) for tile, got in plans if got[-1] <= SMEM_MAX), None)
    if choice is None:
        raise _Decline(f"cuda backend: the sweep's shared planes, ring and staged inputs need "
                       f"{plans[-1][1][-1]} bytes at a {plans[-1][0]} tile, above {SMEM_MAX}")
    tile, (slot, slot_bytes, inputs, nin, smem) = choice
    pp.tile = tile
    pp.smem_bytes = smem
    threads = tile[0] * tile[1]
    return SweepPlan(tile=tile, threads=threads, lead=lead,
                     ring={n: depth for n in sorted(ring)}, slot=slot, slot_bytes=slot_bytes,
                     inputs=inputs, input_bytes=nin, smem_bytes=smem,
                     ctas_per_sm=ctas_per_sm(smem, threads), halo=_halo(ext, stages, tile),
                     plane_secs=[sid for sid, _ in plane.sections],
                     col_secs=[sid for sid, _ in loops[0][1]]), pp


def _loop_rw(loop_secs) -> Tuple[set, List[ir.FieldAccess]]:
    writes, reads = set(), []
    for _, body in loop_secs:
        for s in body:
            writes |= {w.name for w in _stmt_writes(s)}
            reads += _stmt_reads(s)
    return writes, reads


def _fuse_conflict(a, b) -> Optional[str]:
    """Why two serial loops (their sections) cannot share the fused column
    kernel: one reads, at a horizontal offset, a field the other writes
    (a thread owns one column through every loop).  None: they can."""
    for x, y in ((a, b), (b, a)):
        writes, _ = _loop_rw(y)
        _, reads = _loop_rw(x)
        for r in reads:
            if r.name in writes and _ij(r.offset):
                return (f"'{r.name}' is read at a horizontal offset in one serial loop and "
                        "written in another")
    return None


def _reads_vark(stmts) -> bool:
    return any(isinstance(r.offset, ir.VariableKOffset) for s in stmts for r in _stmt_reads(s))


def plan_kernels(analysis: StencilAnalysis, planes_loops=frozenset(),
                 tiles: Optional[bool] = None, fuse_loops: Optional[bool] = None,
                 declined: Optional[Dict[str, str]] = None,
                 sweep: Optional[bool] = None,
                 stage_vark: Optional[bool] = None,
                 held: frozenset = frozenset()) -> List[KernelPlan]:
    """The kernels of a stencil in launch order: a tile kernel per
    PARALLEL section (``tiles`` not False; the stage-split row kernels
    where it declines or ``tiles=False``; each row stage that reads a field
    at a variable K in the staged form, ``_vark_plan``, unless
    ``stage_vark=False``; ``stage_vark=True`` runs a section that reads
    one as row stages in the staged form, or raises), a plane-sweep kernel for the
    serial loops in ``planes_loops`` (by index) and those that read, at a
    horizontal offset, a field they write, a column kernel for the other
    serial loops, and after each run of consecutive column loops their
    fused column kernel (``fuse_loops`` not False), which replaces the
    per-loop ones but for K4.  Where a run follows a loop of
    ``planes_loops`` (a serialized PARALLEL loop) and ``sweep`` is True,
    their sweep kernel (``_plan_sweep``) follows the fused one and
    replaces it and the plane kernel but under K4 and where a call's
    sections overlap; otherwise ``declined["sweep"]`` names why the sweep
    form declines, or that it was not asked for.  A decline is recorded
    in ``declined`` (``tiles=True`` / ``fuse_loops=True`` / ``sweep=True``
    raise instead).  ``held``: temporaries kept in device memory, which
    no form keeps on chip (see ``generate``)."""
    st = analysis.stencil
    declined = {} if declined is None else declined
    plans: List[KernelPlan] = []
    sec_id = 0
    plane_temps = None
    #: plans of the serialized PARALLEL loops (by index in ``plans``)
    serial_planes: set = set()
    touching = _touching_sections(st)
    stencil_writes = {w.name for loop in st.vertical_loops for sec in loop.sections
                      for s in sec.body for w in _stmt_writes(s)}
    #: consecutive column loops: (plans index, loop sections) of the run
    run: List[Tuple[int, list]] = []
    groups: List[List[Tuple[int, list]]] = []
    for li, loop in enumerate(st.vertical_loops):
        if loop.loop_order == ir.LoopOrder.PARALLEL:
            if run:
                groups.append(run)
                run = []
            for section in loop.sections:
                tp = None
                vark = stage_vark is not False and _reads_vark(section.body)
                if stage_vark and vark:
                    if tiles:
                        raise _Forced("cuda backend: tiles=True and stage_vark=True ask for "
                                      "two forms of one section")
                    declined.setdefault("tiles", "cuda backend: stage_vark=True: the section's "
                                        "row stages in the staged form")
                elif tiles is not False:
                    try:
                        tp = _plan_tile(analysis, sec_id, section.body,
                                        _section_local_temps(st, sec_id, section.body,
                                                             touching) - held)
                    except _Decline as e:
                        if tiles:
                            raise
                        declined.setdefault("tiles", str(e))
                if tp is not None and tiles is None and len(tp.planes.stages[sec_id]) == 1 \
                        and not tp.planes.loops:  # the row form cannot iterate a loop group
                    declined.setdefault("tiles", ONE_STAGE)
                    tp = None
                if tp is not None:
                    plans.append(KernelPlan(name="", form="tile", order=loop.loop_order,
                                            sections=[(sec_id, section.body)],
                                            planes=tp.planes, tile=tp))
                    if vark:
                        declined.setdefault("vark", VARK_IN_TILE)
                else:
                    for stage in _split_stages(section.body):
                        vp = None
                        if stage_vark is not False and _reads_vark(stage):
                            try:
                                vp = _vark_plan(st, stage, stencil_writes)
                            except _Decline as e:
                                if stage_vark:
                                    raise _Forced(f"cuda backend: stage_vark=True, but {e}") \
                                        from None
                                declined.setdefault("vark", str(e))
                        plans.append(KernelPlan(name="", form="vark" if vp else "rows",
                                                order=loop.loop_order,
                                                sections=[(sec_id, stage)], vark=vp))
                sec_id += 1
            continue
        secs = []
        for s in loop.sections:
            secs.append((sec_id, s.body))
            sec_id += 1
        if li in planes_loops or _ij_hazard(loop):
            if run:
                groups.append(run)
                run = []
            if plane_temps is None:
                plane_temps = passes.plane_local_temps(st) - held
            pp = _plan_planes(analysis, loop.loop_order, secs, plane_temps)
            if pp.per_level:
                declined["ring"] = f"{pp.per_level}: one launch a level"
            plans.append(KernelPlan(name="", form="planes", order=loop.loop_order,
                                    sections=secs, planes=pp))
            if li in planes_loops:
                serial_planes.add(len(plans) - 1)
        else:
            plans.append(KernelPlan(name="", form="columns", order=loop.loop_order,
                                    sections=secs))
            why = next((w for w in (_fuse_conflict(secs, prev) for _, prev in run) if w), None)
            if why is not None:
                if fuse_loops:
                    raise _Forced(f"cuda backend: fuse_loops=True, but {why}")
                declined.setdefault("fuse_loops", why)
                groups.append(run)
                run = []
            run.append((len(plans) - 1, secs))
    if run:
        groups.append(run)
    swept = 0
    if fuse_loops is not False:
        # each run's fused kernel goes right after its last loop (a run's
        # loops are consecutive plans), and its sweep kernel after that
        last = {g[-1][0]: g for g in groups}
        fused_plans: List[KernelPlan] = []
        for n, p in enumerate(plans):
            fused_plans.append(p)
            if n in last:
                loops = [(plans[m].order, secs) for m, secs in last[n]]
                for q in fused_plans[-len(loops):]:
                    q.k4_only = True
                fused = KernelPlan(name="", form="column", order=loops[0][0],
                                   sections=[sec for _, secs in loops for sec in secs],
                                   group=ColumnGroup(loops=loops))
                fused_plans.append(fused)
                before = last[n][0][0] - 1
                if before not in serial_planes:
                    continue
                plane = plans[before]
                try:
                    sp, pp = _plan_sweep(analysis, plane, loops, plane_temps)
                except _Decline as e:
                    if sweep:
                        raise _Forced(f"cuda backend: sweep=True, but {e}") from None
                    declined.setdefault("sweep", str(e))
                    continue
                if not sweep:
                    declined.setdefault("sweep", SWEEP_OPT_IN)
                    continue
                fused_plans.append(KernelPlan(
                    name="", form="sweep", order=plane.order,
                    sections=plane.sections + fused.sections, planes=pp,
                    group=ColumnGroup(loops=loops), sweep=sp))
                swept += 1
        plans = fused_plans
    if sweep and not swept:
        raise _Forced("cuda backend: sweep=True, but no serialized PARALLEL loop is followed "
                      "by serial loops that fuse")
    if stage_vark and not any(p.vark for p in plans):
        raise _Forced("cuda backend: stage_vark=True, but no PARALLEL section reads a field at "
                      "a variable K")
    if stage_vark is False and any(_reads_vark(body) for p in plans for _, body in p.sections):
        declined.setdefault("vark", "stage_vark=False")
    for n, p in enumerate(plans):
        if p.sweep is not None:
            # the sweep replaces the plane kernel before the run and the
            # run's fused kernel before it
            plans[n - 1].swept_by = n
            plans[n - 2 - len(p.group.loops)].swept_by = n
        p.name = f"{st.name}_k{n}" + {"tile": "_tile", "column": "_col", "sweep": "_sweep",
                                       "vark": "_vk"}.get(p.form, "")
        rect = Extent.zeros()
        for _, stmts in p.sections:
            for s in stmts:
                rect = rect | analysis.extents.stmt_extent(s)
        p.rect = Extent(i=rect.i, j=rect.j)
        reads, writes = [], []
        for _, stmts in p.sections:
            for s in stmts:
                for r in _stmt_reads(s):
                    if r.name not in reads:
                        reads.append(r.name)
                for w in _stmt_writes(s):
                    if w.name not in writes:
                        writes.append(w.name)
        p.reads, p.writes = reads, writes
    return plans


def plan_stencil(analysis: StencilAnalysis, serialize: Optional[bool] = None,
                 tiles: Optional[bool] = None, fuse_loops: Optional[bool] = None,
                 sweep: Optional[bool] = None, stage_vark: Optional[bool] = None,
                 held: frozenset = frozenset()):
    """``(analysis planned, kernels, serialized, declined)``.  A mixed
    stencil (``serialize=None``, where ``SERIALIZE_MIXED`` says), or any
    stencil with a PARALLEL loop (``serialize=True``), runs serialized with
    its PARALLEL loops in the plane-sweep form (K5); where serialization
    declines, ``serialize=None`` keeps the split plan (tile or row kernels
    plus columns) and records why, ``serialize=True`` raises; a stencil
    without a PARALLEL loop has nothing to serialize.  ``serialize=False``
    never serializes.  ``sweep=True`` serializes a mixed stencil and runs
    each serialized PARALLEL loop and the serial loops after it as one
    sweep kernel, or raises naming why it cannot (a stencil that is not
    mixed it leaves as it is, so that a model may pass it to all its
    stencils).
    ``tiles``, ``fuse_loops``, ``stage_vark`` and ``held``: see
    ``plan_kernels``."""
    st = analysis.stencil
    orders = [loop.loop_order for loop in st.vertical_loops]
    mixed = ir.LoopOrder.PARALLEL in orders and len(set(orders)) > 1
    declined: Dict[str, str] = {}
    if sweep and serialize is False:
        raise _Forced("cuda backend: sweep=True runs the serialized loops: not with "
                      "serialize=False")
    parallel = ir.LoopOrder.PARALLEL in orders
    if (serialize and parallel) or (serialize is None and mixed and (sweep or SERIALIZE_MIXED)):
        ser = passes.serialize_parallel_k(st)
        try:
            if ser is None:
                raise _Decline("cuda backend: serialize_parallel_k declined (a runtime "
                               "interval bound, or a K-offset read of a field a PARALLEL "
                               "loop writes)")
            san = analyze(ser)
            loops = frozenset(n for n, o in enumerate(orders) if o == ir.LoopOrder.PARALLEL)
            plans = plan_kernels(san, loops, fuse_loops=fuse_loops, declined=declined,
                                 sweep=sweep, stage_vark=stage_vark, held=held)
            return san, plans, True, declined
        except _Decline as e:
            if serialize or sweep or isinstance(e, _Forced):
                raise
            declined["serialize"] = str(e)
    elif serialize is None and mixed:
        declined["serialize"] = SPLIT_MIXED
    return analysis, plan_kernels(analysis, tiles=tiles, fuse_loops=fuse_loops,
                                  declined=declined, stage_vark=stage_vark,
                                  held=held), False, declined


def _local_temps(analysis: StencilAnalysis, plans: List[KernelPlan]) -> List[str]:
    """Temporaries that can live in registers: every access at offset
    (0, 0, 0) inside one kernel, and either one section or, in each section
    that touches it, an unconditional top-level write before any read.  A
    register declared per K iteration and zeroed then gives exactly the
    oracle's values (its temporaries start at zero)."""
    st = analysis.stencil
    where: Dict[str, set] = {n: set() for n in st.temp_decls}
    sections: Dict[str, set] = {n: set() for n in st.temp_decls}
    ok = {n: not d.data_dims for n, d in st.temp_decls.items()}
    for kn, p in enumerate(plans):
        for sid, stmts in p.sections:
            for s in stmts:
                for node in ir.walk_values(s):
                    if isinstance(node, ir.FieldAccess) and node.name in where:
                        where[node.name].add(kn)
                        sections[node.name].add(sid)
                        if _nonzero(node.offset):
                            ok[node.name] = False
    for p in plans:
        for sid, stmts in p.sections:
            first: Dict[str, str] = {}
            for s in stmts:
                for r in _stmt_reads(s):
                    first.setdefault(r.name, "read")
                if isinstance(s, ir.Assign):
                    first.setdefault(s.target.name, "write")
                else:
                    for w in _stmt_writes(s):
                        first.setdefault(w.name, "cond")
            for name, kind in first.items():
                if name in ok and kind != "write" and len(sections[name]) > 1:
                    ok[name] = False
    return [n for n in st.temp_decls if ok[n] and len(where[n]) == 1]


def _temp_events(analysis: StencilAnalysis, plans: List[KernelPlan], names):
    """Per section (in execution order): the reads ``(name, "r", dk)`` and
    unconditional writes ``(name, "w", 0)`` of the temporaries ``names``,
    in statement order; and the temporaries written or read in any other
    way (under a condition, at a K offset, at a variable or absolute K, or
    per data-dimension component)."""
    events: Dict[int, List[Tuple[str, str, int]]] = {}
    irregular = {n for n in names if analysis.stencil.temp_decls[n].data_dims}
    for p in plans:
        for sid, stmts in p.sections:
            if p.group is not None:
                continue  # a fused kernel repeats its loops' sections
            evs = events.setdefault(sid, [])
            for s in stmts:
                for r in _stmt_reads(s):
                    if r.name not in names:
                        continue
                    if isinstance(r.offset, ir.CartesianOffset):
                        evs.append((r.name, "r", r.offset.k))
                    else:
                        irregular.add(r.name)
                if isinstance(s, ir.Assign) and s.target.name in names:
                    if s.target.offset.k:
                        irregular.add(s.target.name)
                    evs.append((s.target.name, "w", 0))
                elif not isinstance(s, ir.Assign):
                    irregular |= {w.name for w in _stmt_writes(s) if w.name in names}
    return events, irregular


def _covered(need: Tuple[int, int], ranges: List[Tuple[int, int]]) -> bool:
    lo, hi = need
    if hi <= lo:
        return True
    for a, b in sorted(ranges):
        if a <= lo < b:
            lo = b
            if lo >= hi:
                return True
    return False


def zero_init_temps(program: "CudaProgram", kb: Sequence[Tuple[int, int]]) -> List[str]:
    """Scratch temporaries that some read may see before a write.

    The oracle's temporaries start at zero.  A scratch buffer from
    ``torch.empty`` gives the same values only if every level a read
    reaches was written earlier (horizontally, the extent analysis makes
    an unconditional writer cover its readers).  ``kb``: the resolved K
    range of each section.  The rest are zero-filled before the kernels.
    """
    out = []
    for t in program.scratch:
        # a widened writer leaves, beyond the domain, points its ring reads
        # reach and the oracle never computes: they read zero
        if t in program.irregular_writes or t in program.widened:
            out.append(t)
            continue
        before: List[Tuple[int, int]] = []
        safe = True
        for sid in sorted(program.temp_events):
            a, b = kb[sid]
            if b <= a:
                continue
            evs = [(kind, dk) for n, kind, dk in program.temp_events[sid] if n == t]
            writes_here = any(kind == "w" for kind, _ in evs)
            wrote = False
            order = program.section_order[sid]
            for kind, dk in evs:
                if kind == "w":
                    wrote = True
                    continue
                if order == ir.LoopOrder.PARALLEL:
                    same = wrote
                elif order == ir.LoopOrder.FORWARD:
                    same = writes_here and (dk < 0 or (dk == 0 and wrote))
                else:
                    same = writes_here and (dk > 0 or (dk == 0 and wrote))
                if not _covered((a + dk, b + dk), before + ([(a, b)] if same else [])):
                    safe = False
            if writes_here:
                before.append((a, b))
        if not safe:
            out.append(t)
    return out


# --------------------------------------------------------------------------- #
# source emission
# --------------------------------------------------------------------------- #


class _Emitter:
    """Statements and expressions of one kernel at a time: ``locals`` are
    its register temporaries; ``plane`` (plane-sweep form) and ``window``
    (K4) say which reads come from shared memory."""

    def __init__(self, analysis: StencilAnalysis, locals_: Sequence[str]):
        self.analysis = analysis
        self.stencil = analysis.stencil
        self.locals = set(locals_)
        self.written = {
            n for n, info in analysis.field_info.items() if info.access.value & 2
        }
        #: the kernels take the region frame (``_framed``)
        self.framed = _framed(self.stencil)
        self.plane: Optional[PlanePlan] = None
        #: the plane form's current top-level statement: its extent, and
        #: whether it writes beyond its tile (device memory where owned)
        self.stmt_ext = Extent()
        self.own = False
        #: the plane form's sections (order, index) before the current one,
        #: and the current one
        self.done_secs: List[int] = []
        self.sid = 0
        self.plane_order = ir.LoopOrder.FORWARD
        self.window: Optional[WindowPlan] = None
        #: the row form's vector kernel being emitted: its lane is ``l_``
        self.vec: Optional[VectorPlan] = None
        #: the tile form's staged inputs: (name, K offset) -> (extent, pitch,
        #: elements a 16-byte copy moves)
        self.tin: Dict[Tuple[str, int], Tuple[Extent, int, int]] = {}
        #: the fused column kernel: its group, the index of the loop being
        #: emitted, and the current section's prefetched reads -> register
        self.col: Optional[ColumnGroup] = None
        self.col_loop = 0
        self.pf: Dict[Tuple[str, int, int, int], str] = {}
        #: the block-stride loops' threads (a sweep kernel's differ)
        self.threads = PLANE_THREADS
        #: the sweep kernel: field -> depth of its shared ring of levels,
        #: the ring's columns (threads), and its plane part's sections
        self.ring: Dict[str, int] = {}
        self.ring_cols = 0
        self.ring_tile: Tuple[int, int] = (0, 0)
        self.plane_secs: List[int] = []
        #: the staged form (K3): field -> the lambda that reads its window
        #: at a level
        self.vk: Dict[str, str] = {}
        #: K-invariant absolute reads (by ``id``) loaded before the K loop:
        #: the register or shared element that holds each
        self.hoisted: Dict[int, str] = {}

    # ---------------- expressions ---------------- #

    def _shared(self, acc: ir.FieldAccess) -> Optional[str]:
        """The shared-memory element a plane-form access reads or writes:
        a shared temporary, or a mirrored field at the plane's level or an
        earlier one in its ring (``ti``/``tj``: the point relative to the
        tile)."""
        if self.plane is None or acc.name not in self.plane.shared:
            return None
        off = acc.offset
        depth = self.plane.mirrored.get(acc.name, 1)
        if not isinstance(off, ir.CartesianOffset) or (off.k and depth == 1):
            return None
        e = self.plane.shared[acc.name]
        at = self.stmt_ext
        if not (e.i[0] <= at.i[0] + off.i and at.i[1] + off.i <= e.i[1]
                and e.j[0] <= at.j[0] + off.j and at.j[1] + off.j <= e.j[1]):
            raise RuntimeError(
                f"cuda backend: planning bug: '{acc.name}' accessed at I{at.i}+{off.i} "
                f"J{at.j}+{off.j}, beyond its shared plane I{e.i} J{e.j}")
        ni, nj = self.plane.tile[0] + e.i[1] - e.i[0], self.plane.tile[1] + e.j[1] - e.j[0]
        ring = f"gt::slot(k + {off.k}, {depth}) * {ni * nj} + " if depth > 1 else ""
        return (f"sh_{acc.name}[{ring}(ti + {off.i - e.i[0]}) * {nj} + "
                f"(tj + {off.j - e.j[0]})]")

    def _swept(self, level: str) -> str:
        """C test: the plane form's sweep has computed ``level`` (it lies in
        a section already swept, or in the current one behind ``k``)."""
        fwd = self.plane_order == ir.LoopOrder.FORWARD
        cur = f"({level} >= kb.lo[{self.sid}] && {level} < k)" if fwd else \
            f"({level} > k && {level} < kb.hi[{self.sid}])"
        return " || ".join([cur] + [f"({level} >= kb.lo[{s}] && {level} < kb.hi[{s}])"
                                    for s in self.done_secs])

    def _staged(self, acc: ir.FieldAccess) -> Optional[str]:
        """The K window element a K4 access reads (``ti``/``tj``: the
        column in the tile, ``kb0``: the block's first level), or the
        staged input plane a tile-form access reads."""
        if not isinstance(acc.offset, ir.CartesianOffset):
            return None
        off = acc.offset
        if (acc.name, off.k) in self.tin:
            e, pitch, lanes = self.tin[(acc.name, off.k)]
            at = self.stmt_ext
            if not (e.i[0] <= at.i[0] + off.i and at.i[1] + off.i <= e.i[1]
                    and e.j[0] <= at.j[0] + off.j and at.j[1] + off.j <= e.j[1]):
                raise RuntimeError(f"cuda backend: planning bug: '{acc.name}' read beyond "
                                   "its staged plane")
            var = _staged_var(acc.name, off.k)
            step = f"{var}_p" if lanes else pitch
            return f"{var}[(ti + {off.i - e.i[0]}) * {step} + (tj + {off.j - e.j[0]})]"
        if self.window is None:
            return None
        for n, (name, ni, _, _, _, h) in enumerate(self.window.arrays):
            if name == acc.name:
                off = acc.offset
                return (f"w_{name}[((k + {off.k - h.k[0]} - kb0) * {ni} + (ti + "
                        f"{off.i - h.i[0]})) * {self.window.pitch(n)} + (tj + {off.j - h.j[0]})]")
        return None

    def _snapshot(self, acc: ir.FieldAccess) -> bool:
        """A plane-form read of the copy taken before the kernel."""
        return self.plane is not None and id(acc) in self.plane.snapshot_reads

    def valued(self, acc: ir.FieldAccess) -> bool:
        """The access reads a value (register or shared memory, or a ring
        or window read that converts its device-memory branch), not a
        stored 16-bit element."""
        if id(acc) in self.hoisted or self._window(acc) is not None:
            return True
        if self._snapshot(acc):
            return False
        return acc.name in self.locals or self._shared(acc) is not None \
            or self._staged(acc) is not None or self._carried(acc) is not None \
            or self._prefetched(acc) is not None or self._ring(acc) is not None

    def _prefetched(self, acc: ir.FieldAccess) -> Optional[str]:
        """The register a fused column kernel loaded this read into one
        level ahead."""
        if not self.pf or not isinstance(acc.offset, ir.CartesianOffset) or acc.data_index:
            return None
        o = acc.offset
        return self.pf.get((acc.name, o.i, o.j, o.k))

    def _carried(self, acc: ir.FieldAccess) -> Optional[str]:
        """A fused column kernel's access of a carried or whole-column
        temporary: in its writer loop, the register of the level
        (``c_``) or of the level before in the sweep (``p_``); in a later
        loop, its column store (``m_``, stride ``ms_``)."""
        g = self.col
        if g is None or acc.name not in g.writer:
            return None
        k = acc.offset.k
        if g.writer[acc.name] == self.col_loop:
            return f"c_{acc.name}" if k == 0 else f"p_{acc.name}"
        return f"m_{acc.name}[(long long)(k + {k}) * ms_{acc.name}]"

    def _ring(self, acc: ir.FieldAccess) -> Optional[str]:
        """A sweep kernel's column-part read of a field its plane part
        writes: the shared ring's level (column ``ct_`` of the tile) where
        the plane part computed that level, device memory elsewhere."""
        if self.plane is not None or acc.name not in self.ring \
                or not isinstance(acc.offset, ir.CartesianOffset):
            return None
        lev = f"k + {acc.offset.k}"
        sh = f"sr_{acc.name}[gt::slot({lev}, {self.ring[acc.name]}) * {self.ring_cols} + ct_]"
        dt = np.dtype(self.stencil.decl(acc.name).dtype)
        glob = self.global_access(acc)
        if dt in _HALF:
            glob = f"{_HALF[dt][0]}({glob})"
        done = " || ".join(f"({lev} >= kb.lo[{s}] && {lev} < kb.hi[{s}])"
                           for s in self.plane_secs)
        return f"(({done}) ? {sh} : {glob})"

    def _lane(self, acc: ir.FieldAccess) -> Optional[str]:
        """The register a vector kernel's lane ``l_`` reads or writes: its
        element of a written field's array, or of a read-only field's
        window."""
        if self.vec is None or acc.name not in self.vec.fields \
                or not isinstance(acc.offset, ir.CartesianOffset):
            return None
        if acc.name in self.vec.outputs:
            return f"o_{acc.name}[l_]"
        off = acc.offset
        wlo, _ = self.vec.windows[(acc.name, off.i, off.k)]
        return f"{_window_var(acc.name, off.i, off.k)}[l_ + {off.j - wlo}]"

    def _window(self, acc: ir.FieldAccess) -> Optional[str]:
        """A staged-form read of a field at a variable or absolute K: its
        window at the clipped level (device memory where the window does
        not hold it)."""
        if acc.name not in self.vk or isinstance(acc.offset, ir.CartesianOffset):
            return None
        return f"{self.vk[acc.name]}({self._k_index(acc)})"

    def access(self, acc: ir.FieldAccess) -> str:
        hoisted = self.hoisted.get(id(acc))
        if hoisted is not None:
            return hoisted
        if acc.name in self.locals:
            return f"l_{acc.name}"
        window = self._window(acc)
        if window is not None:
            return window
        reg = self._prefetched(acc) or self._carried(acc)
        if reg is not None:
            return reg
        lane = self._lane(acc) or self._ring(acc)
        if lane is not None:
            return lane
        if self._snapshot(acc):
            return self.global_access(acc, var="o_" + acc.name)
        sh = self._shared(acc)
        if sh is not None and acc.offset.k:
            # an earlier plane: the ring holds it once the sweep computed it
            # there; before, device memory holds it and no CTA writes it
            dt = np.dtype(self.stencil.decl(acc.name).dtype)
            glob = self.global_access(acc)
            if dt in _HALF:
                glob = f"{_HALF[dt][0]}({glob})"
            return f"(({self._swept(f'k + {acc.offset.k}')}) ? {sh} : {glob})"
        return sh or self._staged(acc) or self.global_access(acc)

    def global_access(self, acc: ir.FieldAccess, i: str = "i", j: str = "j",
                      k: str = "k", var: Optional[str] = None) -> str:
        """The element of the field's buffer (or of ``var``, a copy of it) at
        the point (i, j, k) plus the access's offset."""
        name, off = acc.name, acc.offset
        is_temp = name in self.stencil.temp_decls
        var = var or ("t_" if is_temp else "f_") + name
        decl = self.stencil.decl(name)
        cart = off if isinstance(off, ir.CartesianOffset) else ir.CartesianOffset()
        ext = self.analysis.extents.field_extent(name)
        wrap = not is_temp and name not in self.written
        idx = []
        for ax, (v, o, dom, flag, e) in enumerate((
            (i, cart.i, "dI", "pI", ext.i),
            (j, cart.j, "dJ", "pJ", ext.j),
        )):
            if not decl.dimensions[ax]:
                idx.append("0")
            elif wrap and (e[0] or e[1]):
                idx.append(f"gt::wrap({v} + {o}, {dom}, {flag})")
            else:
                idx.append(f"{v} + {o}")
        idx.append(self._k_index(acc, k, var) if decl.dimensions[2] else "0")
        if acc.data_index:
            idx.append(" + ".join(
                f"{self.component(e, size, name)} * {var}.sd[{n}]"
                for n, (e, size) in enumerate(zip(acc.data_index, decl.data_dims))
            ))
        return f"{var}.at({', '.join(idx)})"

    def _k_index(self, acc: ir.FieldAccess, k: str = "k", var: Optional[str] = None) -> str:
        """The level an access of a field with a K axis reaches from level
        ``k``: a variable or absolute one clipped to the buffer's levels,
        as the oracle clips."""
        off = acc.offset
        var = var or ("t_" if acc.name in self.stencil.temp_decls else "f_") + acc.name
        if isinstance(off, ir.VariableKOffset):
            code, dt = self.expr(off.k)
            return f"{var}.kclamp({k} + {_cast(code, dt, _I64)})"
        if isinstance(off, ir.AbsoluteKIndex):
            code, dt = self.expr(off.k)
            return f"{var}.kclamp({_cast(code, dt, _I64)})"
        return f"{k} + {off.k}"

    def component(self, e: ir.Expr, size: int, name: str) -> str:
        """One data index: a folded constant, or a per-point index wrapped
        modulo the dimension (the oracle's ``remainder``)."""
        static = try_static_int(e)
        if static is not None:
            return str(_static_component(static, size, name))
        code, dt = self.expr(e)
        return f"gt::imod<long long>({_cast(code, dt, _I64)}, {size}LL)"

    def expr(self, e: ir.Expr) -> Tuple[str, np.dtype]:
        st = self.stencil
        if isinstance(e, ir.Literal):
            if e.dtype is not None:
                dt = np.dtype(e.dtype)
            elif isinstance(e.value, bool):
                dt = _BOOL
            elif isinstance(e.value, (int, np.integer)):
                dt = default_int_dtype(st)
            else:
                dt = default_float_dtype(st)
            return _literal(e.value, dt), dt
        if isinstance(e, ir.ScalarAccess):
            return f"s_{e.name}", np.dtype(st.scalar_decls[e.name].dtype)
        if isinstance(e, ir.FieldAccess):
            dt = np.dtype(st.decl(e.name).dtype)
            if dt in _HALF and not self.valued(e):
                return f"{_HALF[dt][0]}({self.access(e)})", dt
            return self.access(e), dt
        if isinstance(e, ir.AxisPosition):
            dt = default_int_dtype(st)
            pos = e.axis.lower()
            if self.framed and e.axis != "K":
                pos = f"({pos} + g{e.axis}0)"
            return _cast(pos, np.dtype(np.int32), dt), dt
        if isinstance(e, ir.AxisSize):
            dt = default_int_dtype(st)
            size = f"gN{e.axis}" if self.framed and e.axis != "K" else f"d{e.axis}"
            return _cast(size, np.dtype(np.int32), dt), dt
        if isinstance(e, ir.Cast):
            code, dt = self.expr(e.expr)
            return _cast(code, dt, e.dtype), np.dtype(e.dtype)
        if isinstance(e, ir.UnaryOp):
            code, dt = self.expr(e.expr)
            if e.op == ir.UnaryOperator.NOT:
                return f"(!({code}))", _BOOL
            if e.op == ir.UnaryOperator.NEG:
                return f"(({_ctype(dt)})(-({code})))", dt
            return code, dt
        if isinstance(e, ir.BinaryOp):
            return self.binop(e)
        if isinstance(e, ir.TernaryOp):
            c, _ = self.expr(e.cond)
            t, tdt = self.expr(e.true_expr)
            f, fdt = self.expr(e.false_expr)
            target = promote_dtypes(tdt, fdt)
            return f"(({c}) ? {_cast(t, tdt, target)} : {_cast(f, fdt, target)})", target
        if isinstance(e, ir.NativeFuncCall):
            return self.native(e)
        raise NotImplementedError(f"cuda backend: no emitter for {type(e).__name__}")

    def binop(self, e: ir.BinaryOp) -> Tuple[str, np.dtype]:
        l, ldt = self.expr(e.left)
        r, rdt = self.expr(e.right)
        op = e.op
        if op == ir.BinaryOperator.AND:
            return f"(({l}) && ({r}))", _BOOL
        if op == ir.BinaryOperator.OR:
            return f"(({l}) || ({r}))", _BOOL
        target = promote_dtypes(ldt, rdt)
        lc, rc = _cast(l, ldt, target), _cast(r, rdt, target)
        if op.is_comparison:
            return f"({lc} {_BINOP_SYM[op]} {rc})", _BOOL
        if op == ir.BinaryOperator.DIV:
            if not is_float_dtype(target):  # numpy: int / int -> float64
                return f"({_cast(l, ldt, _F64)} / {_cast(r, rdt, _F64)})", _F64
            return _rounded(f"({lc} / {rc})", target), target
        if op == ir.BinaryOperator.FLOOR_DIV:
            fn = "gt::ffloordiv" if is_float_dtype(target) else "gt::ifloordiv"
            return _rounded(f"{fn}<{_ctype(target)}>({lc}, {rc})", target), target
        if op == ir.BinaryOperator.MOD:
            fn = "gt::fmod_py" if is_float_dtype(target) else "gt::imod"
            return _rounded(f"{fn}<{_ctype(target)}>({lc}, {rc})", target), target
        if op == ir.BinaryOperator.POW:
            if is_float_dtype(target):
                fn = "pow" if target == _F64 else "powf"
                return _rounded(f"{fn}({lc}, {rc})", target), target
            return f"gt::ipow<{_ctype(target)}>({lc}, {rc})", target
        code = f"({lc} {_BINOP_SYM[op]} {rc})"
        if not is_float_dtype(target):  # undo C's integer promotion
            code = f"(({_ctype(target)}){code})"
        return _rounded(code, target), target

    def native(self, e: ir.NativeFuncCall) -> Tuple[str, np.dtype]:
        args = [self.expr(a) for a in e.args]
        target = promote_dtypes(*[dt for _, dt in args])
        if len(args) > 1:
            codes = [_cast(c, dt, target) for c, dt in args]
            adt = target
        else:
            codes, adt = [args[0][0]], args[0][1]
        fn = e.func
        if fn in _BOOL_FUNCS:
            x = _cast(codes[0], adt, _F64) if not is_float_dtype(adt) else codes[0]
            return f"((bool){_BOOL_FUNCS[fn]}({x}))", _BOOL
        if fn in _FLOAT_FUNCS:
            if not is_float_dtype(adt):
                codes = [_cast(c, adt, _F64) for c in codes]
                adt = _F64
            name = _FLOAT_FUNCS[fn][1 if adt == _F64 else 0]
            return _rounded(f"{name}({', '.join(codes)})", adt), adt
        ct = _ctype(adt)
        if fn == ir.NativeFunction.ABS:
            if is_float_dtype(adt):
                return f"{'fabs' if adt == _F64 else 'fabsf'}({codes[0]})", adt
            return f"gt::iabs<{ct}>({codes[0]})", adt
        if fn in (ir.NativeFunction.MIN, ir.NativeFunction.MAX):
            which = "minimum" if fn == ir.NativeFunction.MIN else "maximum"
            return f"gt::{which}<{ct}>({codes[0]}, {codes[1]})", adt
        if fn == ir.NativeFunction.MOD:
            helper = "gt::fmod_py" if is_float_dtype(adt) else "gt::imod"
            return _rounded(f"{helper}<{ct}>({codes[0]}, {codes[1]})", adt), adt
        if fn == ir.NativeFunction.POW:
            if is_float_dtype(adt):
                fname = "pow" if adt == _F64 else "powf"
                return _rounded(f"{fname}({codes[0]}, {codes[1]})", adt), adt
            return f"gt::ipow<{ct}>({codes[0]}, {codes[1]})", adt
        raise NotImplementedError(f"cuda backend: no emitter for builtin {fn.value}")

    # ---------------- statements ---------------- #

    def stmt(self, s: ir.Stmt, ind: str) -> List[str]:
        if isinstance(s, ir.Assign):
            code, dt = self.expr(s.value)
            tdt = np.dtype(self.stencil.decl(s.target.name).dtype)
            value = _cast(code, dt, tdt)
            if self.plane is not None:
                return self.plane_assign(s.target, value, tdt, ind)
            if tdt in _HALF and not self.valued(s.target):
                value = f"{_HALF[tdt][1]}({value})"  # exact: value is a 16-bit float
            return [f"{ind}{self.access(s.target)} = {value};"]
        if isinstance(s, ir.If):
            cond, _ = self.expr(s.cond)
            out = [f"{ind}if ({cond}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            if s.orelse:
                out.append(f"{ind}}} else {{")
                for b in s.orelse:
                    out += self.stmt(b, ind + "  ")
            out.append(f"{ind}}}")
            return out
        if isinstance(s, ir.While):
            cond, _ = self.expr(s.cond)
            out = [f"{ind}while ({cond}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            return out + [f"{ind}}}"]
        if isinstance(s, ir.HorizontalRestriction):
            out = [f"{ind}if ({_region_test(s.masks, self.framed)}) {{"]
            for b in s.body:
                out += self.stmt(b, ind + "  ")
            return out + [f"{ind}}}"]
        raise NotImplementedError(f"cuda backend: no emitter for {type(s).__name__}")

    def plane_assign(self, target: ir.FieldAccess, value: str, tdt, ind: str) -> List[str]:
        """A write in the plane-sweep form: to a register or a shared plane;
        a mirrored field to its plane and to device memory; device memory
        only where the CTA owns the point when the statement reaches past
        the tile."""
        name = target.name
        if name in self.locals:
            return [f"{ind}l_{name} = {value};"]
        sh = self._shared(target)
        if sh is not None and name not in self.plane.mirrored:
            return [f"{ind}{sh} = {value};"]
        own = "if (own) " if self.own else ""
        store = f"{_HALF[tdt][1]}(v_)" if tdt in _HALF else "v_"
        ring = ""
        if name in self.ring:
            # a sweep kernel's ring holds the tile's own points
            TI, TJ = self.ring_tile
            ring = (f" if (ti >= 0 && ti < {TI} && tj >= 0 && tj < {TJ}) sr_{name}["
                    f"gt::slot(k, {self.ring[name]}) * {self.ring_cols} + ti * {TJ} + tj] = v_;")
        if sh is not None or ring:
            sh = f" {sh} = v_;" if sh is not None else ""
            return [f"{ind}{{ const {_ctype(tdt)} v_ = {value};{sh} "
                    f"{own}{self.global_access(target)} = {store};{ring} }}"]
        if tdt in _HALF:
            value = f"{_HALF[tdt][1]}({value})"
        return [f"{ind}{own}{self.global_access(target)} = {value};"]

    def plane_guarded(self, s: ir.Stmt, rect: Extent, ind: str) -> List[str]:
        """A statement of a plane-form stage over ``rect`` (the stage's
        extent), guarded by its own extent within the tile."""
        e = self.analysis.extents.stmt_extent(s)
        w = self.plane.extent(self.analysis, s)
        self.stmt_ext = w
        self.own = (w.i, w.j) != ((0, 0), (0, 0))
        inner = ind if (w.i, w.j) == (rect.i, rect.j) and w == e else ind + "  "
        body = []
        for name in self.plane.primed.get(id(s), ()):
            # the value from before the loop, at the point, into its plane
            load = self.global_access(ir.FieldAccess(name), var="o_" + name)
            dt = np.dtype(self.stencil.decl(name).dtype)
            if dt in _HALF:
                load = f"{_HALF[dt][0]}({load})"
            body.append(f"{inner}{self._shared(ir.FieldAccess(name))} = {load};")
        body += self.stmt(s, inner)
        if inner == ind:
            return body
        cond = (f"ti >= {w.i[0]} && i < I1 + {w.i[1]} && "
                f"tj >= {w.j[0]} && j < J1 + {w.j[1]}")
        if w != e:
            # a widened writer computes the neighbours' points, and beyond
            # the domain only its own extent, where the oracle computes it
            cond += (f" && i >= {e.i[0]} && i < dI + {e.i[1]} && "
                     f"j >= {e.j[0]} && j < dJ + {e.j[1]}")
        return [f"{ind}if ({cond}) {{", *body, f"{ind}}}"]

    def guarded(self, s: ir.Stmt, rect: Extent, ind: str) -> List[str]:
        e = self.analysis.extents.stmt_extent(s)
        if (e.i, e.j) == (rect.i, rect.j):
            return self.stmt(s, ind)
        cond = (f"i >= {e.i[0]} && i < dI + {e.i[1]} && "
                f"j >= {e.j[0]} && j < dJ + {e.j[1]}")
        return [f"{ind}if ({cond}) {{", *self.stmt(s, ind + "  "), f"{ind}}}"]

    def registers(self, stmts: Sequence[ir.Stmt], ind: str) -> List[str]:
        """Declarations, zeroed, of the register temporaries ``stmts`` use."""
        used: List[str] = []
        for s in stmts:
            for node in ir.walk_values(s):
                if isinstance(node, ir.FieldAccess) and node.name in self.locals \
                        and node.name not in used:
                    used.append(node.name)
        out = []
        for n in used:
            ct = _ctype(self.stencil.temp_decls[n].dtype)
            out.append(f"{ind}{ct} l_{n} = ({ct})0;")
        return out


def _bytes_per_point(analysis: StencilAnalysis, plan: KernelPlan, locals_) -> int:
    st = analysis.stencil
    n = 0
    for names in (plan.reads, plan.writes):
        for name in names:
            if name not in locals_:
                decl = st.decl(name)
                n += np.dtype(decl.dtype).itemsize * int(np.prod(decl.data_dims, dtype=int))
    return n


def _in_device_memory(p: KernelPlan, name: str, locals_) -> bool:
    """A kernel reaches ``name`` in device memory (not a register or, in
    the plane-sweep form, only a shared plane)."""
    if p.sweep is not None and (name in p.planes.registers or (
            name in p.planes.shared and name not in p.planes.mirrored)):
        return False
    if p.group is not None:
        g = p.group
        return name not in locals_ and name not in g.carries and name not in g.columns
    if p.planes is None:
        return name not in locals_
    pp = p.planes
    return name not in pp.registers and (name not in pp.shared or name in pp.mirrored)


def _kblock_eligibility(analysis: StencilAnalysis, plans: List[KernelPlan]):
    """``(reason, passes, promoted)``: why K4 cannot run the stencil (None
    when it can), and ``passes.split_serial_passes``'s passes and promoted
    temporaries.  The reasons are the JAX package's (``_trace_kblocked``),
    but for variable and absolute K reads of fields the stencil does not
    write: the kernels read those from device memory, whole, whatever the
    block (the windows hold only Cartesian reads)."""
    st = analysis.stencil
    if not any(p.form == "columns" for p in plans):
        return "no loop in the column form", 0, []
    written = {n.target.name for n in ir.walk_values(st.vertical_loops)
               if isinstance(n, ir.Assign)}
    for node in ir.walk_values(st.vertical_loops):
        if isinstance(node, ir.FieldAccess) and node.name in written and \
                isinstance(node.offset, (ir.VariableKOffset, ir.AbsoluteKIndex)):
            return "a variable or absolute K access of a field the stencil writes", 0, []
    if any(sec.interval.is_runtime for loop in st.vertical_loops for sec in loop.sections):
        return "a runtime interval bound", 0, []
    pass_stencils, promoted = passes.split_serial_passes(st)
    for n in sorted(promoted):
        e = analysis.extents.alloc_extent(n)
        if e.i != (0, 0) or e.j != (0, 0):
            return f"the promoted temporary '{n}' has I/J halos", 0, []
    return None, len(pass_stencils), sorted(promoted)


def _plan_window(analysis: StencilAnalysis, p: KernelPlan, locals_) -> WindowPlan:
    """K4's window of a column kernel: every 3-D field without data
    dimensions it reads and does not write, at Cartesian offsets only."""
    st = analysis.stencil
    hull: Dict[str, Extent] = {}
    skip = set(p.writes) | set(locals_)
    for _, stmts in p.sections:
        for s in stmts:
            for r in _stmt_reads(s):
                decl = st.decl(r.name)
                if not isinstance(r.offset, ir.CartesianOffset) or decl.data_dims \
                        or not all(decl.dimensions):
                    skip.add(r.name)
                    continue
                o = Extent.from_offset(r.offset.i, r.offset.j, r.offset.k)
                hull[r.name] = hull.get(r.name, o) | o
    arrays, lanes = [], []
    for n, h in hull.items():
        if n not in skip:
            size = _value_size(st.decl(n).dtype)
            arrays.append((n, KB_TILE_I + h.i[1] - h.i[0], KB_TILE_J + h.j[1] - h.j[0],
                           h.k[1] - h.k[0], size, h))
            # stored as held: copied asynchronously, 16 bytes where it can
            lanes.append(16 // size if np.dtype(st.decl(n).dtype).itemsize == size
                         and size in (4, 8) else 0)
    return WindowPlan(arrays=arrays, lanes=lanes)


def vector_candidate(decl) -> bool:
    """A field the vector kernels may reach with 16-byte accesses: it has a
    J axis and no data dimensions (whether its view is J-contiguous and
    aligned is checked at launch)."""
    return bool(decl.dimensions[1]) and not decl.data_dims


def _plan_vector(analysis: StencilAnalysis, p: KernelPlan, locals_) -> Optional[VectorPlan]:
    """The vector variant of a row-form stage, or None when the stage
    reaches no J-contiguous field in device memory (see ``VectorPlan``).
    Within a stage a field it writes is accessed only at offset (0, 0, 0)
    (``_split_stages`` cuts at any other access), so a register per lane
    holds it; reads at a variable or absolute K stay scalar loads."""
    st = analysis.stencil
    ext = analysis.extents
    fields = [n for n in p.reads + p.writes
              if n not in locals_ and vector_candidate(st.decl(n))]
    if not fields:
        return None
    V = 16 // min(np.dtype(st.decl(n).dtype).itemsize for n in fields)
    outputs = [n for n in p.writes if n in fields]
    need: Dict[Tuple[str, int, int], Extent] = {}
    djs: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
    access: Dict[str, Extent] = {}
    stores: Dict[str, Extent] = {}
    #: output -> the extent of its first access when that is an
    #: unconditional write (None when a read or a compound statement)
    first_write: Dict[str, Optional[Extent]] = {}
    reads_by_sid: Dict[int, List[Tuple[str, int, int]]] = {}
    for sid, stmts in p.sections:
        keys = reads_by_sid.setdefault(sid, [])
        for s in stmts:
            e = ext.stmt_extent(s)
            e = Extent(i=e.i, j=e.j)
            targets = {w.name for w in _stmt_writes(s)}
            reads = _stmt_reads(s)
            for n in outputs:
                if n not in first_write and (n in targets or any(r.name == n for r in reads)):
                    first_write[n] = e if isinstance(s, ir.Assign) and not any(
                        r.name == n for r in reads) else None
            for r in reads:
                if r.name not in fields:
                    continue
                access[r.name] = access.get(r.name, e) | e
                if r.name in outputs or not isinstance(r.offset, ir.CartesianOffset):
                    continue
                key = (r.name, r.offset.i, r.offset.k)
                if key not in keys:
                    keys.append(key)
                at = e + Extent.from_offset(0, r.offset.j)
                need[key] = need.get(key, at) | at
                lo, hi = djs.get(key, (r.offset.j, r.offset.j))
                djs[key] = (min(lo, r.offset.j), max(hi, r.offset.j))
            for n in targets & set(outputs):
                access[n] = access.get(n, e) | e
                stores[n] = stores.get(n, e) | e
    windows = {}
    for key, (lo, hi) in djs.items():
        wlo = (lo // V) * V
        windows[key] = (wlo, ((V - 1 + hi) // V) * V + V - wlo)
    # an unconditional write of the whole access hull first: every lane is
    # written before it is read or stored, and nothing need be loaded
    preload = {n: access[n] for n in outputs if first_write.get(n) != access[n]}
    return VectorPlan(V=V, fields=fields, windows=windows, need=need, outputs=outputs,
                      preload=preload, stores=stores, reads=reads_by_sid)


def _plan_group(analysis: StencilAnalysis, p: KernelPlan, locals_) -> None:
    """Where the fused column kernel ``p`` keeps its temporaries (see
    ``ColumnGroup``) and which reads it loads a level ahead.  A temporary
    qualifies when it is accessed only in the group's loops, at offset
    (0, 0) in I and J, written (at offset 0) in one loop, read there only
    at its level or the level before in that loop's sweep, and in no
    earlier loop; a whole-column one (read by a later loop) also needs a
    type of 32 or 64 bits."""
    g = p.group
    st = analysis.stencil
    loop_of = {sid: li for li, (_, secs) in enumerate(g.loops) for sid, _ in secs}
    touching = _touching_sections(st)
    acc: Dict[str, List[Tuple[int, bool, ir.Offset]]] = {}
    for li, (_, secs) in enumerate(g.loops):
        for _, stmts in secs:
            for s in stmts:
                for w in _stmt_writes(s):
                    acc.setdefault(w.name, []).append((li, True, w.offset))
                for r in _stmt_reads(s):
                    acc.setdefault(r.name, []).append((li, False, r.offset))
    for t, decl in st.temp_decls.items():
        if t in locals_ or decl.data_dims or t not in acc or not touching[t] <= set(loop_of):
            continue
        uses = acc[t]
        if any(not isinstance(o, ir.CartesianOffset) or o.i or o.j for _, _, o in uses):
            continue
        writers = {li for li, w, _ in uses if w}
        if len(writers) != 1 or any(w and o.k for _, w, o in uses):
            continue
        (L,) = writers
        back = -1 if g.loops[L][0] == ir.LoopOrder.FORWARD else 1
        if any(not w and (li < L or (li == L and o.k not in (0, back))) for li, w, o in uses):
            continue
        if any(li > L for li, _, _ in uses):
            if np.dtype(decl.dtype) in _HALF:
                continue
            g.columns.append(t)
        else:
            g.carries.append(t)
        g.writer[t] = L
    ext = analysis.extents
    # a field another loop of the group writes is read at (0, 0) (the
    # fusion's condition): that loop ran before this one, or runs after it,
    # in the same thread, so a read of the next level may go ahead.  A
    # sweep kernel loads nothing ahead: with its first loop's loads held a
    # level ahead (106 registers against 64) it took 1.02 ms against 0.78,
    # and 1.13 with its later loops' too (114), at 512 x 512 x 80 float32
    # on the H100 (PERF.md, K5)
    loop_writes = [_loop_rw(secs)[0] for _, secs in g.loops]
    for li, (_, secs) in enumerate(g.loops):
        for sid, stmts in secs:
            keys = g.prefetch.setdefault(sid, [])
            if p.sweep is not None:
                continue
            for s in stmts:
                e = ext.stmt_extent(s)
                if not isinstance(s, ir.Assign) or (e.i, e.j) != (p.rect.i, p.rect.j):
                    continue
                for r in ir.field_accesses(s.value):
                    o = r.offset
                    key = (r.name, getattr(o, "i", 0), getattr(o, "j", 0), getattr(o, "k", 0))
                    # inputs, and a whole-column temporary's store in a
                    # loop after its writer's
                    stored = r.name in g.columns and g.writer[r.name] < li
                    if isinstance(o, ir.CartesianOffset) and not r.data_index and \
                            r.name not in locals_ and key not in keys and (stored or (
                                r.name not in loop_writes[li] and r.name not in g.writer)):
                        keys.append(key)


@dataclass
class CudaProgram:
    """The generated source and what the wrapper needs to call it."""

    source: str
    kernels: List[KernelPlan]
    fields: List[str]
    scratch: List[str]
    locals: List[str]
    #: fields copied before a plane-sweep kernel that reads them ahead
    snapshots: List[str]
    float_scalars: List[str]
    int_scalars: List[str]
    intervals: List[ir.Interval]
    bytes_per_point: Dict[str, int]
    #: what ``zero_init_temps`` reads: temporary accesses per section,
    #: temporaries written conditionally or at K offsets, loop orders
    temp_events: Dict[int, List[Tuple[str, str, int]]]
    irregular_writes: set
    section_order: Dict[int, ir.LoopOrder]
    #: the analysis the kernels were planned on (the serialized stencil's
    #: when ``serialized``)
    analysis: Optional[StencilAnalysis] = None
    serialized: bool = False
    #: form -> why it declined
    declined: Dict[str, str] = field(default_factory=dict)
    #: K4: ``split_serial_passes``'s passes and promoted temporaries;
    #: built with ``k_blocked`` unset (K4 where ``kb_default`` says),
    #: and why K4 cannot run the stencil (None: it can)
    kb_passes: int = 0
    kb_promoted: List[str] = field(default_factory=list)
    kb_default: bool = False
    kb_declined_deep: Optional[str] = None
    #: plane-sweep writers widened for ring reads: field -> rectangle
    widened: Dict[str, Extent] = field(default_factory=dict)

    def plan_record(self) -> dict:
        """The stencil's ``LAST_PLAN`` entry before a launch: ``forms`` are
        the kernels a one-pass call launches, in order (K4's window
        kernels replace the fused column kernel where K4 runs)."""
        planes = [k.planes for k in self.kernels if k.form == "planes"]
        on_chip = [k.planes for k in self.kernels if k.planes]
        return {
            "forms": [k.form for k in self.kernels if not k.k4_only and k.swept_by is None],
            "serialized": self.serialized,
            "kblocked": False,
            "tile": list(planes[0].tile) if planes else None,
            "shared": sorted({n for pp in on_chip for n in pp.shared}),
            "registers": sorted(set(self.locals) | {n for pp in on_chip for n in pp.registers}),
            "scratch": list(self.scratch),
            "snapshots": list(self.snapshots),
            "smem_bytes": [pp.smem_bytes for pp in planes],
            "widened": {n: [list(e.i), list(e.j)] for n, e in self.widened.items()},
            "tiles": [k.tile.record(k.name) for k in self.kernels if k.tile],
            "columns": [{"kernel": k.name, "loops": len(k.group.loops),
                         "carries": list(k.group.carries), "columns": list(k.group.columns),
                         "prefetch": sum(len(v) for v in k.group.prefetch.values())}
                        for k in self.kernels if k.group and k.swept_by is None],
            "sweep": [k.sweep.record(k.name) for k in self.kernels if k.sweep],
            "declined": dict(self.declined),
            # the staged kernels (K3), where the stencil has any
            **({"vark": [k.vark.record(k.name) for k in self.kernels if k.vark]}
               if any(k.vark for k in self.kernels) else {}),
        }

    def vector_row_fields(self) -> set:
        """The fields the vector row kernels reach."""
        return {n for k in self.kernels if k.vector for n in k.vector.fields}

    def staged_fields(self) -> set:
        """The fields the tile and sweep kernels stage with 16-byte copies."""
        return {name for k in self.kernels for staged in (k.tile, k.sweep) if staged
                for name, _, _, _, lanes in staged.inputs if lanes}

    def vector_fields(self) -> set:
        """The fields the vector row kernels and the 16-byte staging of the
        tile and sweep kernels reach."""
        return self.vector_row_fields() | self.staged_fields()

    def vector_width(self, names) -> int:
        """Elements a 16-byte word holds of the smallest of ``names``."""
        st = self.analysis.stencil
        return 16 // min(np.dtype(st.decl(n).dtype).itemsize for n in names)

    def kblock_plan(self, columns: int, dK: int):
        """``(KB per window kernel, None)`` when K4 runs on ``columns`` =
        dI x dJ columns of ``dK`` levels, else ``(None, reason)``; built
        with ``k_blocked`` unset, K4 runs where ``kb_default`` says."""
        windows = [k.window for k in self.kernels if k.window is not None]
        if self.kb_default and not kb_default(columns, dK):
            return None, KB_DEFAULT_ONE_PASS
        if not windows:
            return None, self.kb_declined_deep
        if dK < 2:
            return None, "a depth below 2"
        kbs = [w.choose_kb(dK) for w in windows]
        if None in kbs:
            return None, "no K window of 8 levels fits one CTA's shared memory"
        return kbs, None


def _emit_plain_kernel(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """A row-form stage or a column-form loop."""
    ind = "    "
    out = [
        "",
        f"// {p.name}: {p.form} form ({p.order.name}), rect I{p.rect.i} J{p.rect.j}; "
        f"~{bpp} bytes per grid point",
        f"__global__ void __launch_bounds__({BLOCK_J * BLOCK_I}) {p.name}(",
        "    " + ",\n    ".join(params) + ") {",
        f"  const int j = {p.rect.j[0]} + (int)(blockIdx.x * blockDim.x + threadIdx.x);",
        f"  const int i = {p.rect.i[0]} + (int)(blockIdx.y * blockDim.y + threadIdx.y);",
        f"  if (i >= dI + {p.rect.i[1]} || j >= dJ + {p.rect.j[1]}) return;",
    ]
    out += _hoist_registers(em, [s for _, stmts in p.sections for s in stmts], set(p.writes),
                            p.rect, "  ")
    for sid, stmts in p.sections:
        out.append(_k_loop(p.order, sid, "  "))
        out += em.registers(stmts, ind)
        for s in stmts:
            out += em.guarded(s, p.rect, ind)
        out.append("  }")
    em.hoisted = {}
    return out + ["}"]


def _window_params(params: List[str]) -> List[str]:
    """A K4 kernel's parameters: the stencil's, the section bounds as
    ``kb_all`` (each block clips its own ``kb``), and the block size."""
    return [q.replace("> kb", "> kb_all") if q.startswith("gt::KBounds<") else q
            for q in params] + ["int KB"]


def _window_sizes(w: WindowPlan) -> List[str]:
    """C declarations of a window kernel's slot layout in KB: each staged
    array's byte offset in a slot (``a<n>_``) and the slot's bytes."""
    out, at = [], "0"
    for n, (_, ni, _, kh, size, _) in enumerate(w.arrays):
        out.append(f"a{n}_ = {at}")
        at = f"a{n}_ + ((size_t){ni * w.pitch(n) * size} * (size_t)(KB + {kh}) + 15) / 16 * 16"
    return out + [f"slot_ = {at}"]


def _emit_window_kernel(em: _Emitter, p: KernelPlan, params: List[str]) -> List[str]:
    """K4's variant of a column loop (``<loop>_kb``): one launch; each
    thread sweeps its column block by block in the loop's order, the
    block's window of read-only inputs in a ring of ``slots`` slots in
    shared memory, each block's window copied in with ``cp.async`` (16
    bytes where the row is contiguous and aligned, one element otherwise)
    while the blocks before it are swept."""
    wp = p.window
    S = wp.slots
    nthreads = KB_TILE_I * KB_TILE_J
    nsec = next(q for q in params if q.startswith("gt::KBounds<")).split()[0]
    fwd = p.order == ir.LoopOrder.FORWARD
    which = "b_" if fwd else "nb_ - 1 - b_"
    out = [
        "",
        f"// {p.name}_kb: K-blocked column form ({p.order.name}), one launch sweeping the K "
        f"blocks through a ring of {S} slots, rect I{p.rect.i} J{p.rect.j}; staged: "
        f"{', '.join(a[0] for a in wp.arrays) or '-'}",
        f"__global__ void __launch_bounds__({nthreads}) {p.name}_kb(",
        "    " + ",\n    ".join(_window_params(params)) + ") {",
        "  GT_DYNAMIC_SMEM(gt_smem);",
        "  const int tj = (int)threadIdx.x, ti = (int)threadIdx.y;",
        f"  const int tid_ = ti * {KB_TILE_J} + tj;",
        f"  const int bj = {p.rect.j[0]} + (int)blockIdx.x * {KB_TILE_J}, "
        f"bi = {p.rect.i[0]} + (int)blockIdx.y * {KB_TILE_I};",
        "  const int j = bj + tj, i = bi + ti;",
        "  const int nb_ = (dK + KB - 1) / KB;",
        "  const size_t " + ", ".join(_window_sizes(wp)) + ";",
        "  (void)tid_;",
        f"  // the b_-th block in the sweep's order: its levels, into slot b_ % {S}",
        "  auto stage_ = [&](int b_) {",
        f"    const int kb0 = ({which}) * KB, kb1 = kb0 + KB < dK ? kb0 + KB : dK;",
        f"    unsigned char* const s_ = gt_smem + (size_t)(b_ % {S}) * slot_;",
    ]
    for n, (name, ni, nj, kh, size, h) in enumerate(wp.arrays):
        dt = em.stencil.decl(name).dtype
        ct = _ctype(dt)
        var = ("t_" if name in em.stencil.temp_decls else "f_") + name
        V, pitch = wp.lanes[n], wp.pitch(n)

        def at(j: str, em=em, name=name) -> str:
            return em.global_access(ir.FieldAccess(name), i="gi", j=j, k="gk")

        ilim = f"dI + {p.rect.i[1] + h.i[1]}"
        jlim = f"dJ + {p.rect.j[1] + h.j[1]}"
        kmask = f"gk < {var}.klo || gk > {var}.khi"
        out += ["    {", f"      {ct}* const w_ = ({ct}*)(s_ + a{n}_);"]
        if V:
            nch = -(-nj // V)
            out += [
                f"      for (int p_ = tid_; p_ < {ni * nch} * (kb1 - kb0 + {kh}); "
                f"p_ += {nthreads}) {{",
                f"        const int kk = p_ / {ni * nch}, r_ = p_ % {ni * nch};",
                f"        const int row_ = r_ / {nch}, c_ = (r_ % {nch}) * {V};",
                f"        const int gi = bi + {h.i[0]} + row_, gj = bj + {h.j[0]} + c_, "
                f"gk = kb0 + {h.k[0]} + kk;",
                f"        if (gi >= {ilim} || {kmask}) continue;",
                f"        {ct}* const d_ = w_ + (kk * {ni} + row_) * {pitch} + c_;",
                f"        const {ct}* const a_ = &{at('gj')};",
                f"        if (c_ + {V} <= {nj} && gj + {V - 1} < {jlim} && "
                f"&{at(f'gj + {V - 1}')} == a_ + {V - 1} && "
                "(reinterpret_cast<size_t>(a_) & 15) == 0) {",
                "          gt::async_copy<16>(d_, a_);",
                "        } else {",
                f"          for (int e_ = 0; e_ < {V} && c_ + e_ < {nj} && gj + e_ < {jlim}; ++e_)",
                f"            gt::async_copy<{size}>(d_ + e_, &{at('gj + e_')});",
                "        }",
                "      }",
            ]
        else:
            load = at("gj")
            if np.dtype(dt) in _HALF:
                load = f"{_HALF[np.dtype(dt)][0]}({load})"
            out += [
                f"      for (int p_ = tid_; p_ < {ni * nj} * (kb1 - kb0 + {kh}); "
                f"p_ += {nthreads}) {{",
                f"        const int kk = p_ / {ni * nj}, r_ = p_ % {ni * nj};",
                f"        const int gi = bi + {h.i[0]} + r_ / {nj}, "
                f"gj = bj + {h.j[0]} + r_ % {nj}, gk = kb0 + {h.k[0]} + kk;",
                f"        if (gi < {ilim} && gj < {jlim} && !({kmask})) "
                f"w_[(kk * {ni} + r_ / {nj}) * {pitch} + r_ % {nj}] = {load};",
                "      }",
            ]
        out.append("    }")
    out += [
        "  };",
        f"  for (int b_ = 0; b_ < {S - 1}; ++b_) {{",
        "    if (b_ < nb_) stage_(b_);",
        "    gt::async_commit();",
        "  }",
        "  for (int b_ = 0; b_ < nb_; ++b_) {",
        f"    if (b_ + {S - 1} < nb_) stage_(b_ + {S - 1});",
        "    gt::async_commit();",
        f"    gt::async_wait<{S - 1}>();",
        "    __syncthreads();",
        f"    const int kb0 = ({which}) * KB, kb1 = kb0 + KB < dK ? kb0 + KB : dK;",
        f"    unsigned char* const s_ = gt_smem + (size_t)(b_ % {S}) * slot_;",
        "    (void)kb1; (void)s_;",
    ]
    for n, (name, *_rest) in enumerate(wp.arrays):
        ct = _ctype(em.stencil.decl(name).dtype)
        out.append(f"    const {ct}* const w_{name} = (const {ct}*)(s_ + a{n}_);")
    out += [f"    if (i < dI + {p.rect.i[1]} && j < dJ + {p.rect.j[1]}) {{",
            f"      {nsec} kb = kb_all;"]
    for sid, _ in p.sections:
        out += [f"      kb.lo[{sid}] = kb_all.lo[{sid}] > kb0 ? kb_all.lo[{sid}] : kb0;",
                f"      kb.hi[{sid}] = kb_all.hi[{sid}] < kb1 ? kb_all.hi[{sid}] : kb1;"]
    em.window = wp
    ind = "        "
    for sid, stmts in p.sections:
        out.append(_k_loop(p.order, sid, "      "))
        out += em.registers(stmts, ind)
        for s in stmts:
            out += em.guarded(s, p.rect, ind)
        out.append("      }")
    em.window = None
    return out + ["    }", "    __syncthreads();", "  }", "}"]


def _staged_var(name: str, ok: int) -> str:
    return f"st_{name}_k{ok}".replace("-", "m")


def _window_var(name: str, oi: int, ok: int) -> str:
    num = lambda x: f"m{-x}" if x < 0 else str(x)  # noqa: E731
    return f"w_{name}_i{num(oi)}_k{num(ok)}"


def _emit_vector_rows(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The vector kernel of a row-form stage (``VectorPlan``): thread
    (g, i) computes the J points ``j0 .. j0 + V - 1``, ``j0 = vj0 + g V``;
    gt_run sets ``vj0`` on the fields' common 16-byte phase, so every
    group's accesses are aligned words.  A group entirely inside the
    stage's rectangle (``full``) loads each window and stores each output
    as whole words; a partial group, a window that reaches past what its
    readers need, or one that straddles a periodic J seam, takes its
    elements one by one from the row's pointer (J is contiguous: no index
    arithmetic per element, which costs registers).  A lane outside the
    rectangle computes
    nothing.  The grid's ``VSPLIT_K`` z blocks share the stage's
    (independent, PARALLEL) levels."""
    vp = p.vector
    V = vp.V
    st = em.stencil
    r = p.rect
    ind = "      "
    out = [
        "",
        f"// {p.name}_v: {p.form} form, vector kernel: {V} consecutive J points a thread, "
        f"16-byte loads and stores of {', '.join(vp.fields)}; rect I{r.i} J{r.j}",
        f"__global__ void __launch_bounds__({VBLOCK_J * VBLOCK_I}) {p.name}_v(",
        "    " + ",\n    ".join(params + ["int vj0", "int vng"]) + ") {",
        "  const int g_ = (int)(blockIdx.x * blockDim.x + threadIdx.x);",
        f"  const int i = {r.i[0]} + (int)(blockIdx.y * blockDim.y + threadIdx.y);",
        f"  if (g_ >= vng || i >= dI + {r.i[1]}) return;",
        f"  const int j0 = vj0 + g_ * {V};",
        f"  const bool full = j0 >= {r.j[0]} && j0 + {V} <= dJ + {r.j[1]};",
    ]

    def var(name):
        return ("t_" if name in st.temp_decls else "f_") + name

    def index(name, oi, k):
        """Row and level of ``name`` at I offset ``oi`` and level ``k``."""
        decl = st.decl(name)
        wrap = name not in st.temp_decls and name not in em.written
        e = em.analysis.extents.field_extent(name)
        row = "0" if not decl.dimensions[0] else (
            f"gt::wrap(i + {oi}, dI, pI)" if wrap and (e.i[0] or e.i[1]) else f"i + {oi}")
        return row, (k if decl.dimensions[2] else "0"), wrap and bool(e.j[0] or e.j[1])

    out += _hoist_registers(em, [s for _, stmts in p.sections for s in stmts], set(p.writes),
                            None, "  ", lanes=V)
    em.vec = vp
    for sid, stmts in p.sections:
        # PARALLEL levels are independent: the grid's z blocks split them
        out.append(f"  for (int k = kb.lo[{sid}] + (int)blockIdx.z; k < kb.hi[{sid}]; "
                   "k += (int)gridDim.z) {")
        for name, oi, ok in vp.reads[sid]:
            wlo, n = vp.windows[(name, oi, ok)]
            ct = _stype(st.decl(name).dtype)
            w = _window_var(name, oi, ok)
            need = vp.need[(name, oi, ok)]
            row, lev, wrap_j = index(name, oi, f"k + {ok}")
            s0 = f"j0 + {wlo}"
            seam = f" && (!pJ || ({s0} >= 0 && {s0} + {n} <= dJ))" if wrap_j else ""
            jj = "gt::wrap(jj, dJ, pJ)" if wrap_j else "jj"
            # the window's row from its first element (J is contiguous)
            out += [
                f"    alignas(16) {ct} {w}[{n}];",
                f"    if (i >= {need.i[0]} && i < dI + {need.i[1]}) {{",
                f"      const {ct}* p_ = &{var(name)}.at({row}, {s0}, {lev});",
                f"      if (full && {s0} + {V} > {need.j[0]} && {s0} + {n - V} < dJ + {need.j[1]}"
                f"{seam}) gt::vload<{ct}, {n}>({w}, p_);",
                "      else {",
                "#pragma unroll",
                f"        for (int x_ = 0; x_ < {n}; ++x_) {{",
                f"          const int jj = {s0} + x_;",
                f"          if (jj >= {need.j[0]} && jj < dJ + {need.j[1]}) "
                f"{w}[x_] = p_[{jj} - ({s0})];",
                "        }",
                "      }",
                "    }",
            ]
        for name in vp.outputs:
            ct = _stype(st.decl(name).dtype)
            out.append(f"    alignas(16) {ct} o_{name}[{V}];")
            if name not in vp.preload:
                continue
            e = vp.preload[name]
            row, lev, _ = index(name, 0, "k")
            out += [
                f"    if (i >= {e.i[0]} && i < dI + {e.i[1]}) {{",
                f"      const {ct}* p_ = &{var(name)}.at({row}, j0, {lev});",
                f"      if (j0 >= {e.j[0]} && j0 + {V} <= dJ + {e.j[1]}) "
                f"gt::vload<{ct}, {V}>(o_{name}, p_);",
                "      else {",
                "#pragma unroll",
                f"        for (int l_ = 0; l_ < {V}; ++l_) {{",
                "          const int j = j0 + l_;",
                f"          if (j >= {e.j[0]} && j < dJ + {e.j[1]}) o_{name}[l_] = p_[l_];",
                "        }",
                "      }",
                "    }",
            ]
        out += [
            "#pragma unroll",
            f"    for (int l_ = 0; l_ < {V}; ++l_) {{",
            "      const int j = j0 + l_;",
            f"      if (j < {r.j[0]} || j >= dJ + {r.j[1]}) continue;",
        ]
        out += em.registers(stmts, ind)
        for s in stmts:
            out += em.guarded(s, p.rect, ind)
        out.append("    }")
        for name in vp.outputs:
            ct = _stype(st.decl(name).dtype)
            e = vp.stores[name]
            row, lev, _ = index(name, 0, "k")
            out += [
                f"    if (i >= {e.i[0]} && i < dI + {e.i[1]}) {{",
                f"      {ct}* p_ = &{var(name)}.at({row}, j0, {lev});",
                f"      if (j0 >= {e.j[0]} && j0 + {V} <= dJ + {e.j[1]}) "
                f"gt::vstore<{ct}, {V}>(p_, o_{name});",
                "      else {",
                "#pragma unroll",
                f"        for (int l_ = 0; l_ < {V}; ++l_) {{",
                "          const int j = j0 + l_;",
                f"          if (j >= {e.j[0]} && j < dJ + {e.j[1]}) p_[l_] = o_{name}[l_];",
                "        }",
                "      }",
                "    }",
            ]
        out.append("  }")
    em.vec = None
    em.hoisted = {}
    return out + ["}"]


def _hoist_load(em: _Emitter, r: ir.FieldAccess) -> str:
    """The value of a hoisted read at the thread's (i, j), from device
    memory (its index's reads too)."""
    saved = em.vk, em.vec, em.plane, em.tin, em.col
    em.vk, em.vec, em.plane, em.tin, em.col = {}, None, None, {}, None
    try:
        load = em.global_access(r)
    finally:
        em.vk, em.vec, em.plane, em.tin, em.col = saved
    dt = np.dtype(em.stencil.decl(r.name).dtype)
    return f"{_HALF[dt][0]}({load})" if dt in _HALF else load


def _in_extent(e: Extent, i: str = "i", j: str = "j") -> str:
    return f"{i} >= {e.i[0]} && {i} < dI + {e.i[1]} && {j} >= {e.j[0]} && {j} < dJ + {e.j[1]}"


def _hoist_registers(em: _Emitter, stmts: Sequence[ir.Stmt], written, rect: Optional[Extent],
                     ind: str, lanes: int = 0) -> List[str]:
    """The K-invariant absolute reads of ``stmts`` (``_hoistable``) loaded
    once, before the K loop, into registers at the thread's (i, j) -- with
    ``lanes``, one a lane of a vector kernel's group (``j0 + l_``) -- each
    where a statement that reads it computes, zero elsewhere (no test
    where that is the kernel's ``rect``, inside which every thread lies;
    None: threads may lie outside it); the emitter reads them from there
    (``em.hoisted``)."""
    reads = _hoistable(em.stencil, stmts, written)
    exts = _hoist_extents(em.analysis.extents, stmts, reads)
    regs: Dict[str, Tuple[str, Extent, str]] = {}
    for r in reads:
        load = _hoist_load(em, r)
        reg, e, ct = regs.get(load, (f"hk{len(regs)}_", exts[id(r)],
                                     _ctype(em.stencil.decl(r.name).dtype)))
        regs[load] = (reg, e | exts[id(r)], ct)
        em.hoisted[id(r)] = f"{reg}[l_]" if lanes else reg
    out = []
    for load, (reg, e, ct) in regs.items():
        if lanes:
            out += [f"{ind}{ct} {reg}[{lanes}];",
                    "#pragma unroll",
                    f"{ind}for (int l_ = 0; l_ < {lanes}; ++l_) {{",
                    f"{ind}  const int j = j0 + l_;",
                    f"{ind}  {reg}[l_] = ({_in_extent(e)}) ? {load} : ({ct})0;",
                    f"{ind}}}"]
        elif rect is not None and (e.i, e.j) == (rect.i, rect.j):
            out.append(f"{ind}const {ct} {reg} = {load};")
        else:
            out.append(f"{ind}const {ct} {reg} = ({_in_extent(e)}) ? {load} : ({ct})0;")
    return out


def _hoist_planes(em: _Emitter, pp: PlanePlan, base: int, threads: int) -> List[str]:
    """A tile or plane-sweep kernel's K-invariant absolute reads
    (``PlanePlan.hoisted``) loaded once, before its K loop, into shared
    planes at byte ``base`` over the rectangles of the statements that read
    them (zero where none computes in the domain); the emitter reads them
    there (``em.hoisted``)."""
    out = []
    at = base
    for n, (r, e, dom) in enumerate(pp.hoisted):
        dt = np.dtype(em.stencil.decl(r.name).dtype)
        ct = _ctype(dt)
        ni, nj = pp.tile[0] + e.i[1] - e.i[0], pp.tile[1] + e.j[1] - e.j[0]
        out.append(f"  {ct}* const hp{n}_ = ({ct}*)(gt_smem + {at});")
        out += _tile_points(pp.tile, e, "  ", threads)
        out += [f"    hp{n}_[p_] = ({_in_extent(dom)}) ? {_hoist_load(em, r)} : ({ct})0;",
                "  }"]
        at += _align16(ni * nj * _value_size(dt))
        em.hoisted[id(r)] = f"hp{n}_[(ti - {e.i[0]}) * {nj} + (tj - {e.j[0]})]"
    if pp.hoisted:
        out.append("  __syncthreads();")
    return out


def _emit_vark(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The staged form of a row-form stage (``VarkPlan``; K3 on Hopper):
    thread t of a CTA owns column (I0 + t / TJ % TI, J0 + t % TJ) at level
    lane t / (TI TJ), and the CTA marches the stage's levels ``lanes`` a
    step.  Each gathered field's window holds S levels of the CTA's
    columns: the whole buffer column, loaded once before the march, or a
    ring (level L in slot L mod S) of ``lanes`` + b + a levels around the
    step, b behind and a ahead, whose next step's new levels are copied
    with ``cp.async`` while a step computes.  A window row starts at the
    aligned-down 16-byte word of its first element (its lead read back from
    its address), each word one 16-byte copy where it is contiguous,
    aligned and inside the field's storage, element copies elsewhere.  A
    read at a variable or absolute K is a shared-memory load at its clipped
    level where the window holds it; elsewhere it loads from device memory
    and counts one read outside the window (``vko_``)."""
    vp = p.vark
    TI, TJ = vp.tile
    LZ = vp.lanes
    T = TI * TJ
    threads = T * LZ
    st = em.stencil
    r = p.rect
    ((sid, stmts),) = p.sections
    nf = len(vp.fields)
    out = [
        "",
        f"// {p.name}: staged form (PARALLEL section {sid}), {TI}x{TJ} columns x {LZ} levels a "
        f"step, {threads} threads; windows of {[n for n, *_ in vp.fields]} in shared memory "
        f"(the whole buffer column or a ring of levels); rect I{r.i} J{r.j}; ~{bpp} bytes per "
        "grid point",
        f"__global__ void __launch_bounds__({threads}) {p.name}(",
        "    " + ",\n    ".join(params + [f"gt::Slots<{nf}> vs_", "unsigned long long* vko_"])
        + ") {",
        "  GT_DYNAMIC_SMEM(gt_smem);",
        f"  const int t_ = (int)threadIdx.x, lz_ = t_ / {T};",
        f"  const int I0 = {r.i[0]} + (int)blockIdx.y * {TI}, J0 = {r.j[0]} + (int)blockIdx.x * {TJ};",
        f"  const int I1 = I0 + {TI} < dI + {r.i[1]} ? I0 + {TI} : dI + {r.i[1]};",
        f"  const int J1 = J0 + {TJ} < dJ + {r.j[1]} ? J0 + {TJ} : dJ + {r.j[1]};",
        f"  const int i = I0 + t_ / {TJ} % {TI}, j = J0 + t_ % {TJ};",
        f"  const int kl_ = kb.lo[{sid}], kh_ = kb.hi[{sid}];",
        "  const bool on_ = i < I1 && j < J1;",
        "  unsigned long long vkn_ = 0;",
        "  size_t wo_ = 0;",
    ]
    out += _hoist_registers(em, stmts, set(p.writes), None, "  ")
    for n, (name, pitch, lanes, size) in enumerate(vp.fields):
        dt = np.dtype(st.decl(name).dtype)
        ct, sct = _ctype(dt), _stype(dt)
        var = "f_" + name
        acc = ir.FieldAccess(name)

        def at(i: str, j: str, acc=acc) -> str:
            return em.global_access(acc, i=i, j=j, k="L")

        out += [
            f"  {ct}* const w{n}_ = ({ct}*)(gt_smem + wo_);",
            f"  const int s{n}_ = vs_.s[{n}], n{n}_ = {var}.khi - {var}.klo + 1;",
            f"  const bool wh{n}_ = s{n}_ >= n{n}_;",
            f"  wo_ += ((size_t)s{n}_ * {vp.level_bytes(n)} + 15) / 16 * 16;",
            f"  // a ring holds the step's {LZ} levels, the next step's and b behind and a ahead",
            f"  const int b{n}_ = wh{n}_ ? n{n}_ : (s{n}_ - {2 * LZ}) / 2;",
            f"  const int a{n}_ = wh{n}_ ? n{n}_ : s{n}_ - {2 * LZ} - b{n}_;",
            f"  auto wlo{n}_ = [&](int k0) {{ return k0 - b{n}_ > {var}.klo ? k0 - b{n}_ : "
            f"{var}.klo; }};",
            f"  auto whi{n}_ = [&](int k0) {{ return k0 + {LZ - 1} + a{n}_ < {var}.khi ? "
            f"k0 + {LZ - 1} + a{n}_ : {var}.khi; }};",
            f"  auto ws{n}_ = [&](int L) {{ return wh{n}_ ? L - {var}.klo : gt::slot(L, s{n}_); }};",
            f"  int lo{n}_ = wlo{n}_(kl_), hi{n}_ = whi{n}_(kl_);",
            f"  // levels L0 .. L1 of '{name}' into their slots",
            f"  auto st{n}_ = [&](int L0, int L1) {{",
        ]
        nch = pitch // lanes if lanes else TJ
        out += [
            f"    for (int p_ = t_; p_ < (L1 - L0 + 1) * {TI * nch}; p_ += {threads}) {{",
            f"      const int L = L0 + p_ / {TI * nch}, r_ = p_ / {nch} % {TI}, c_ = p_ % {nch};",
            "      const int gi = I0 + r_;",
            "      if (gi >= I1) continue;",
            f"      {ct}* const row_ = w{n}_ + ((size_t)ws{n}_(L) * {TI} + r_) * {pitch};",
        ]
        if lanes:
            out += [
                f"      const int gj = J0 - gt::lead16(&{at('gi', 'J0')}) + c_ * {lanes};",
                "      if (gj >= J1) continue;",
                f"      {ct}* const d_ = row_ + c_ * {lanes};",
                f"      const {sct}* const a_ = &{at('gi', 'gj')};",
                f"      if (&{at('gi', f'gj + {lanes - 1}')} == a_ + {lanes - 1} && "
                f"(reinterpret_cast<size_t>(a_) & 15) == 0 && {var}.holds16(a_)) {{",
                "        gt::async_copy<16>(d_, a_);",
                "      } else {",
                f"        for (int e_ = 0; e_ < {lanes}; ++e_)",
                "          if (gj + e_ >= J0 && gj + e_ < J1) "
                f"gt::async_copy<{size}>(d_ + e_, &{at('gi', 'gj + e_')});",
                "      }",
            ]
        else:
            load = at("gi", "J0 + c_")
            if dt in _HALF:
                load = f"{_HALF[dt][0]}({load})"
            out.append(f"      if (J0 + c_ < J1) row_[c_] = {load};")
        glob = at("i", "j")
        if dt in _HALF:
            glob = f"{_HALF[dt][0]}({glob})"
        lead = f" + gt::lead16(&{at('i', 'J0')})" if lanes else ""
        out += [
            "    }",
            "  };",
            f"  auto vk{n}_ = [&](long long L_) -> {ct} {{",
            "    const int L = (int)L_;",
            f"    if (L >= lo{n}_ && L <= hi{n}_)",
            f"      return w{n}_[((size_t)ws{n}_(L) * {TI} + (i - I0)) * {pitch}{lead} + (j - J0)];",
            "    ++vkn_;",
            f"    return {glob};",
            "  };",
        ]
    fields = range(nf)
    out += [
        "  const bool ring_ = " + " || ".join(f"!wh{n}_" for n in fields) + ";",
        "  if (kl_ < kh_) {",
        *[f"    st{n}_(lo{n}_, hi{n}_);" for n in fields],
        "  }",
        "  gt::async_commit();",
        "  if (!ring_) gt::async_wait<0>();",
        "  __syncthreads();",
        f"  for (int k0_ = kl_; k0_ < kh_; k0_ += {LZ}) {{",
        "    if (ring_) {",
        f"      if (k0_ + {LZ} < kh_) {{",
        *[f"        st{n}_(whi{n}_(k0_) + 1, whi{n}_(k0_ + {LZ}));" for n in fields],
        "      }",
        "      gt::async_commit();",
        "      gt::async_wait<1>();",
        "      __syncthreads();",
        *[f"      lo{n}_ = wlo{n}_(k0_); hi{n}_ = whi{n}_(k0_);" for n in fields],
        "    }",
        "    const int k = k0_ + lz_;",
        "    if (on_ && k < kh_) {",
    ]
    em.vk = {name: f"vk{n}_" for n, (name, *_) in enumerate(vp.fields)}
    out += em.registers(stmts, "      ")
    for s in stmts:
        out += em.guarded(s, r, "      ")
    em.vk = {}
    em.hoisted = {}
    return out + ["    }", "    if (ring_) __syncthreads();", "  }",
                  "  if (vkn_) atomicAdd(vko_, vkn_);", "}"]


def _k_loop(order: ir.LoopOrder, sid: int, ind: str) -> str:
    if order == ir.LoopOrder.BACKWARD:
        return f"{ind}for (int k = kb.hi[{sid}] - 1; k >= kb.lo[{sid}]; --k) {{"
    return f"{ind}for (int k = kb.lo[{sid}]; k < kb.hi[{sid}]; ++k) {{"


def _tile_points(tile: Tuple[int, int], e: Extent, ind: str,
                 threads: int = PLANE_THREADS) -> List[str]:
    """A block-stride loop over the tile widened by ``e``: ``(ti, tj)``
    relative to the tile's origin ``(I0, J0)``, ``(i, j)`` in the domain;
    the tile's interior ends at ``(I1, J1)``."""
    TI, TJ = tile
    ni, nj = TI + e.i[1] - e.i[0], TJ + e.j[1] - e.j[0]
    return [
        f"{ind}for (int p_ = (int)threadIdx.x; p_ < {ni * nj}; p_ += {threads}) {{",
        f"{ind}  const int ti = {e.i[0]} + p_ / {nj}, tj = {e.j[0]} + p_ % {nj};",
        f"{ind}  const int i = I0 + ti, j = J0 + tj;",
        f"{ind}  if (i >= I1 + {e.i[1]} || j >= J1 + {e.j[1]}) continue;",
    ]


def _plane_level(em: _Emitter, p: KernelPlan, sid: int) -> List[str]:
    """One level of a plane-sweep or tile kernel (inside its K loop): the
    mirrored fields' planes loaded, then each stage over its widened
    rectangle, ``__syncthreads()`` after each."""
    pp = p.planes
    st = em.stencil
    out = []
    if pp.mirrored:
        for name, depth in pp.mirrored.items():
            dt = np.dtype(st.decl(name).dtype)
            e = pp.shared[name]
            plane = (pp.tile[0] + e.i[1] - e.i[0]) * (pp.tile[1] + e.j[1] - e.j[0])
            load = em.global_access(ir.FieldAccess(name))
            if dt in _HALF:
                load = f"{_HALF[dt][0]}({load})"
            ring = f"gt::slot(k, {depth}) * {plane} + " if depth > 1 else ""
            out += _tile_points(pp.tile, e, "    ", em.threads)
            a = em.analysis.extents.alloc_extent(name)
            if not _covers(a, e):
                # a plane grown past the field's storage (a writer widened
                # for a CTA-iterated loop): no value is read there
                load = (f"(i >= {a.i[0]} && i < dI + {a.i[1]} && j >= {a.j[0]} && "
                        f"j < dJ + {a.j[1]}) ? {load} : 0")
            out += [f"      sh_{name}[{ring}p_] = {load};", "    }"]
        out.append("    __syncthreads();")
    for stage in pp.stages[sid]:
        if len(stage) == 1 and id(stage[0]) in pp.loops:
            out += _loop_group_lines(em, pp, stage[0])
            continue
        rect = Extent.zeros()
        for s in stage:
            rect = rect | pp.extent(em.analysis, s)
        rect = Extent(i=rect.i, j=rect.j)
        out += _tile_points(pp.tile, rect, "    ", em.threads)
        if any(pp.extent(em.analysis, s) != Extent() and any(
                _in_device_memory(p, w.name, ()) for w in _stmt_writes(s)) for s in stage):
            out.append("      const bool own = (I0 == 0 || ti >= 0) && (I1 == dI || i < I1)"
                       " && (J0 == 0 || tj >= 0) && (J1 == dJ || j < J1);")
        out += em.registers(stage, "      ")
        for s in stage:
            out += em.plane_guarded(s, rect, "      ")
        out += ["    }", "    __syncthreads();"]
    return out


_OWN = ("      const bool own = (I0 == 0 || ti >= 0) && (I1 == dI || i < I1)"
        " && (J0 == 0 || tj >= 0) && (J1 == dJ || j < J1);")


def _loop_group_lines(em: _Emitter, pp: PlanePlan, w: ir.While) -> List[str]:
    """A ``_loop_group`` ``while`` in the plane form: its carried fields'
    planes primed from their snapshots (the values from before the loop,
    where the field's storage holds them), a mask a point (``wm<n>_``) of
    the condition over the loop's rectangle within the statement's extent
    in the domain, then one iteration at a time for the whole CTA, while
    any point of the CTA is active (``__syncthreads_or``): each body stage
    over the rectangle for the active points, ``__syncthreads()`` after
    each, then the mask and-ed with the condition -- the oracle's
    iteration, plane-wide, as its neighbours' values are computed by the
    CTA itself."""
    n = list(pp.loops).index(id(w))
    stages, q = pp.loops[id(w)]
    e = em.analysis.extents.stmt_extent(w)
    inside = f"i >= {e.i[0]} && i < dI + {e.i[1]} && j >= {e.j[0]} && j < dJ + {e.j[1]}"
    em.stmt_ext = q
    em.own = True
    mask = f"wm{n}_"
    out = [f"    // while loop iterated by the CTA over I{q.i} J{q.j}"]
    for name in pp.primed.get(id(w), ()):
        a = em.analysis.extents.alloc_extent(name)
        load = em.global_access(ir.FieldAccess(name), var="o_" + name)
        dt = np.dtype(em.stencil.decl(name).dtype)
        if dt in _HALF:
            load = f"{_HALF[dt][0]}({load})"
        out += _tile_points(pp.tile, pp.shared[name], "    ", em.threads)
        out += [f"      if (i >= {a.i[0]} && i < dI + {a.i[1]} && j >= {a.j[0]} && "
                f"j < dJ + {a.j[1]}) sh_{name}[p_] = {load};", "    }"]
    cond, _ = em.expr(w.cond)
    out += ["    __syncthreads();"] + _tile_points(pp.tile, q, "    ", em.threads) + [
        f"      {mask}[p_] = ({inside}) && ({cond});", "    }", "    __syncthreads();",
        "    for (;;) {", "      int a_ = 0;"]
    out += _tile_points(pp.tile, q, "      ", em.threads) + [
        f"        a_ |= {mask}[p_];", "      }", "      if (!__syncthreads_or(a_)) break;"]
    for stage in stages:
        out += _tile_points(pp.tile, q, "      ", em.threads)
        out += ["  " + _OWN, f"        if ({mask}[p_]) {{"]
        for b in stage:
            out += em.stmt(b, "          ")
        out += ["        }", "      }", "      __syncthreads();"]
    out += _tile_points(pp.tile, q, "      ", em.threads) + [
        f"        if ({mask}[p_]) {mask}[p_] = ({cond});", "      }", "      __syncthreads();",
        "    }"]
    return out


def _tile_origin(TI: int, TJ: int) -> List[str]:
    return [
        f"  const int I0 = (int)blockIdx.y * {TI}, J0 = (int)blockIdx.x * {TJ};",
        f"  const int I1 = I0 + {TI} < dI ? I0 + {TI} : dI, J1 = J0 + {TJ} < dJ ? J0 + {TJ} : dJ;",
    ]


def _emit_planes(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The plane-sweep kernel of one serial loop (see the module
    docstring): ``(ti, tj)`` is a point relative to the tile's origin
    ``(I0, J0)``; the tile's interior ends at ``(I1, J1)``."""
    pp = p.planes
    TI, TJ = pp.tile
    st = em.stencil
    em.plane = pp
    em.locals = set(pp.registers)
    out = [
        "",
        f"// {p.name}: planes form ({p.order.name}), tile {TI}x{TJ}, {PLANE_THREADS} threads; "
        f"shared {sorted(pp.shared)}, mirrored (planes kept) {pp.mirrored}, "
        f"registers {pp.registers}; "
        f"~{bpp} bytes per grid point",
        f"__global__ void __launch_bounds__({PLANE_THREADS}) {p.name}(",
        "    " + ",\n    ".join(params) + ") {",
        "  GT_DYNAMIC_SMEM(gt_smem);",
    ]
    off = 0
    for name, e in pp.shared.items():
        ct = _ctype(st.decl(name).dtype)
        out.append(f"  {ct}* const sh_{name} = ({ct}*)(gt_smem + {off});")
        off += _align16((TI + e.i[1] - e.i[0]) * (TJ + e.j[1] - e.j[0])
                        * _value_size(st.decl(name).dtype) * pp.mirrored.get(name, 1))
    for n, nbytes in enumerate(pp.mask_bytes(pp.tile)):
        out.append(f"  unsigned char* const wm{n}_ = gt_smem + {off};")
        off += nbytes
    out += _tile_origin(TI, TJ)
    out += _hoist_planes(em, pp, off, PLANE_THREADS)
    em.plane_order = p.order
    em.done_secs = []
    for sid, _ in p.sections:
        em.sid = sid
        out.append(_k_loop(p.order, sid, "  "))
        out += _plane_level(em, p, sid)
        out.append("  }")
        em.done_secs.append(sid)
    em.plane = None
    em.hoisted = {}
    return out + ["}"]


def _emit_staging(em: _Emitter, tile: Tuple[int, int], inputs, ring: int,
                  slot_bytes: int) -> List[str]:
    """``stage_(k, s_)``: level k's staged inputs into slot s_ of the ring
    at byte ``ring`` of the dynamic shared memory, and ``lead<n>_(k)`` (K6
    on Hopper).  A row of a 16-byte staged input starts at the aligned-down
    word of its first needed element, whatever the row's phase.  Its lead
    (the elements before that element) is ``(l + r s) mod lanes`` for row
    r, ``l = lead<n>_(k)`` from the address of the first row inside the
    domain, ``s`` the row pitch in elements modulo ``lanes``; element j of
    row r lies at ``r (pitch + s) + l + j - j0`` -- rows step by
    ``pitch + s``, a shift the reads fold into their row stride and their
    base pointer, so they index as the aligned layout did.  Each word goes
    by one 16-byte ``cp.async`` where its elements are contiguous and
    aligned and it lies inside the field's storage (``Field::holds16``);
    the others -- a periodic tile's wrapped rows and words, a word that
    would cross the allocation, a J axis that is not contiguous -- element
    by element.  A converted input (16-bit storage) is loaded
    synchronously."""
    st = em.stencil
    TI, TJ = tile
    layout, _ = _staging_layout(st, tile, inputs)
    out = []
    for n, (name, dk, e, pitch, lanes) in enumerate(inputs):
        if not lanes:
            continue
        acc = ir.FieldAccess(name)
        at = em.global_access(acc, i="ia_", j="ja_", k=f"k + {dk}")
        out += [f"  auto lead{n}_ = [&](int k) {{",
                # anchored on the first row and element inside the domain: a
                # periodic tile's rows and words stay aligned past its wrapped ones
                f"    const int ia_ = I0 + {e.i[0]} < 0 ? 0 : I0 + {e.i[0]}, "
                f"ja_ = J0 + {e.j[0]} < 0 ? 0 : J0 + {e.j[0]};",
                f"    return (gt::lead16(&{at}) - (ia_ - I0 - {e.i[0]}) * {_staged_var(name, dk)}_s"
                f" + (J0 + {e.j[0]} - ja_)) & {lanes - 1};",
                "  };"]
    out += ["  // level k's staged inputs into slot s_ of the ring",
            "  auto stage_ = [&](int k, int s_) {",
            f"    unsigned char* const r_ = gt_smem + {ring} + (size_t)s_ * {slot_bytes};"]
    for n, ((name, dk, e, pitch, lanes), arr) in enumerate(zip(inputs, layout)):
        dt = np.dtype(st.decl(name).dtype)
        ct = _ctype(dt)
        rows = TI + e.i[1] - e.i[0]
        var = ("t_" if name in st.temp_decls else "f_") + name
        sv = _staged_var(name, dk)

        def gat(j: str, name=name) -> str:
            return em.global_access(ir.FieldAccess(name), i="gi", j=j, k="gk")

        out += ["    {", f"      {ct}* const w_ = ({ct}*)(r_ + {arr});"]
        if lanes:
            nch = pitch // lanes
            out += [
                f"      const int l_ = lead{n}_(k);",
                f"      for (int p_ = (int)threadIdx.x; p_ < {rows * nch}; "
                f"p_ += {em.threads}) {{",
                f"        const int row_ = p_ / {nch}, c_ = (p_ % {nch}) * {lanes};",
                f"        const int gi = I0 + {e.i[0]} + row_, gk = k + {dk};",
                f"        if (gi >= I1 + {e.i[1]}) continue;",
                # the row's lead plus its whole words of shift
                f"        const int sh_ = l_ + row_ * {sv}_s;",
                f"        const int gj = J0 + {e.j[0]} - (sh_ & {lanes - 1}) + c_;",
                f"        if (gj >= J1 + {e.j[1]}) continue;",
                f"        {ct}* const d_ = w_ + row_ * {pitch} + (sh_ & ~{lanes - 1}) + c_;",
                f"        const {ct}* const a_ = &{gat('gj')};",
                f"        if (&{gat(f'gj + {lanes - 1}')} == a_ + {lanes - 1} && "
                f"(reinterpret_cast<size_t>(a_) & 15) == 0 && {var}.holds16(a_)) {{",
                "          gt::async_copy<16>(d_, a_);",
                "        } else {",
                f"          for (int e_ = 0; e_ < {lanes}; ++e_)",
                f"            if (gj + e_ >= J0 + {e.j[0]} && gj + e_ < J1 + {e.j[1]}) "
                f"gt::async_copy<{dt.itemsize}>(d_ + e_, &{gat('gj + e_')});",
                "        }",
                "      }",
            ]
        else:
            nj = TJ + e.j[1] - e.j[0]
            load = gat("gj")
            if dt in _HALF:
                load = f"{_HALF[dt][0]}({load})"
            out += [
                f"      for (int p_ = (int)threadIdx.x; p_ < {rows * nj}; "
                f"p_ += {em.threads}) {{",
                f"        const int gi = I0 + {e.i[0]} + p_ / {nj}, "
                f"gj = J0 + {e.j[0]} + p_ % {nj}, gk = k + {dk};",
                f"        if (gi < I1 + {e.i[1]} && gj < J1 + {e.j[1]}) w_[p_] = {load};",
                "      }",
            ]
        out.append("    }")
    return out + ["  };"]


def _staged_row_pitches(em: _Emitter, inputs, uniform: bool = False) -> List[str]:
    """Each 16-byte staged input's row pitch in elements modulo its lanes
    (``_s``: the step of its rows' leads) and its rows' stride in the
    ring (``_p``); with ``uniform`` (a call whose staged rows are all on
    one lead: row pitches of whole words) the constants 0 and ``pitch``,
    so that the reads index as the constant-pitch layout does."""
    st = em.stencil
    out = []
    for name, dk, _, pitch, lanes in inputs:
        if lanes:
            var = _staged_var(name, dk)
            field = ("t_" if name in st.temp_decls else "f_") + name
            step = "0" if uniform else f"(int)({field}.si & {lanes - 1})"
            out += [f"  const int {var}_s = {step};",
                    f"  const int {var}_p = {pitch} + {var}_s;"]
    return out


def _staged_pointers(em: _Emitter, tile: Tuple[int, int], inputs, ring: int,
                     slot_bytes: int, ind: str) -> List[str]:
    """The staged inputs of level k in slot ``s_``, each at its first row's
    lead, as the emitter's ``_staged`` reads them."""
    st = em.stencil
    layout, _ = _staging_layout(st, tile, inputs)
    out = []
    for n, ((name, dk, _, _, lanes), arr) in enumerate(zip(inputs, layout)):
        ct = _ctype(st.decl(name).dtype)
        lead = f" + lead{n}_(k)" if lanes else ""
        out.append(f"{ind}const {ct}* const {_staged_var(name, dk)} = (const {ct}*)(gt_smem + "
                   f"{ring} + (size_t)s_ * {slot_bytes} + {arr}){lead};")
    return out


def _emit_tile(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The tile kernel of one PARALLEL section (``TilePlan``), and where it
    stages 16-byte rows its ``_u`` twin for calls whose staged rows all
    share one lead (``_emit_tile_kernel``); ``gt_run`` launches one of the
    two by the call's flag."""
    out = _emit_tile_kernel(em, p, params, bpp, p.name, False)
    if any(lanes for *_, lanes in p.tile.inputs):
        out += _emit_tile_kernel(em, p, params, bpp, p.name + "_u", True)
    return out


def _emit_tile_kernel(em: _Emitter, p: KernelPlan, params: List[str], bpp: int, name: str,
                      uniform: bool) -> List[str]:
    """A tile kernel of one PARALLEL section (``TilePlan``): grid
    (J tiles, I tiles, K blocks of ``kz`` levels); each level runs the
    section's stages as the plane-sweep form runs a plane, its shared
    planes in slots reused by liveness.  The staged inputs of level k + 1
    are copied into one slot of a two-slot ring while level k computes
    (``_emit_staging``: 16-byte ``cp.async`` from each row's aligned-down
    word, at any row phase).  ``uniform``: the twin for calls whose staged
    rows share one lead, its rows' stride a constant (the general kernel's
    register stride cost 5-13 % of device time on such calls on the H100,
    PERF.md, K6)."""
    tp = p.tile
    pp = tp.planes
    TI, TJ = tp.tile
    st = em.stencil
    ((sid, _),) = p.sections
    em.plane = pp
    em.locals = set(pp.registers)
    em.plane_order = ir.LoopOrder.PARALLEL
    em.done_secs = []
    em.sid = sid
    staged = [f"{n}@k{dk}" for n, dk, *_ in tp.inputs]
    out = [
        "",
        f"// {name}: tile form (PARALLEL section {sid}), tile {TI}x{TJ}, {tp.kz} levels a CTA, "
        f"{PLANE_THREADS} threads; shared {sorted(pp.shared)} in {len(tp.slot_bytes)} slots, "
        f"mirrored {sorted(pp.mirrored)}, registers {pp.registers}, staged {staged}"
        f"{' (rows on one lead)' if uniform else ''}, {tp.smem_bytes} shared bytes; ~{bpp} "
        "bytes per grid point",
        f"__global__ void __launch_bounds__({PLANE_THREADS}) {name}(",
        "    " + ",\n    ".join(params) + ") {",
        "  GT_DYNAMIC_SMEM(gt_smem);",
    ]
    offs, at = [], 0
    for b in tp.slot_bytes:
        offs.append(at)
        at += b
    for name in pp.shared:
        ct = _ctype(st.decl(name).dtype)
        out.append(f"  {ct}* const sh_{name} = ({ct}*)(gt_smem + {offs[tp.slot[name]]});")
    ring = at
    out += _tile_origin(TI, TJ) + [
        f"  const int k0_ = kb.lo[{sid}] + (int)blockIdx.z * {tp.kz};",
        f"  const int k1_ = k0_ + {tp.kz} < kb.hi[{sid}] ? k0_ + {tp.kz} : kb.hi[{sid}];",
    ]
    if tp.inputs:
        out += _staged_row_pitches(em, tp.inputs, uniform)
        out += _emit_staging(em, tp.tile, tp.inputs, ring, tp.input_bytes)
        out += ["  if (k0_ < k1_) stage_(k0_, 0);", "  gt::async_commit();"]
    out += _hoist_planes(em, pp, ring + 2 * tp.input_bytes, PLANE_THREADS)
    off = ring + 2 * tp.input_bytes + _hoist_bytes(st, pp.hoisted, tp.tile)
    for n, nbytes in enumerate(pp.mask_bytes(tp.tile)):
        out.append(f"  unsigned char* const wm{n}_ = gt_smem + {off};")
        off += nbytes
    out.append("  for (int k = k0_; k < k1_; ++k) {")
    if tp.inputs:
        out += ["    const int s_ = (k - k0_) & 1;",
                "    if (k + 1 < k1_) stage_(k + 1, s_ ^ 1);",
                "    gt::async_commit();",
                "    gt::async_wait<1>();",
                "    __syncthreads();"]
        out += _staged_pointers(em, tp.tile, tp.inputs, ring, tp.input_bytes, "    ")
    em.tin = {(name, dk): (e, pitch, lanes) for name, dk, e, pitch, lanes in tp.inputs}
    out += _plane_level(em, p, sid)
    em.tin = {}
    em.plane = None
    em.hoisted = {}
    return out + ["  }", "}"]


def _column_heads(em: _Emitter, g: ColumnGroup, i: str, j: str, ind: str) -> List[str]:
    """A fused column kernel's whole-column stores (``m_``, stride
    ``ms_``) at column (i, j), and its carried registers, zeroed."""
    st = em.stencil
    out = []
    for t in g.columns:
        ct = _ctype(st.temp_decls[t].dtype)
        out += [f"{ind}{ct}* const m_{t} = &t_{t}.at({i}, {j}, 0);",
                f"{ind}const long long ms_{t} = t_{t}.sk;"]
    for t in g.carries + g.columns:
        ct = _ctype(st.temp_decls[t].dtype)
        out.append(f"{ind}{ct} c_{t} = ({ct})0, p_{t} = ({ct})0;")
    return out


def _column_level(em: _Emitter, g: ColumnGroup, li: int, stmts, r: Extent, step: int,
                  ind: str) -> List[str]:
    """One level k of a section of loop ``li`` of a fused column kernel:
    its carries moved on (``p_`` the level before in the sweep, zero where
    the loop did not sweep it), its statements, its whole-column stores,
    ``kl_`` set to k."""
    st = em.stencil
    out = []
    mine = [t for t, w in g.writer.items() if w == li]
    for t in mine:
        if any(isinstance(x, ir.FieldAccess) and x.name == t and x.offset.k
               for s in stmts for x in ir.walk_values(s)):
            ct = _ctype(st.temp_decls[t].dtype)
            out.append(f"{ind}p_{t} = kl_ == k - {step} ? c_{t} : ({ct})0;")
        out.append(f"{ind}c_{t} = ({_ctype(st.temp_decls[t].dtype)})0;")
    out += em.registers(stmts, ind)
    for s in stmts:
        out += em.guarded(s, r, ind)
    for t in mine:
        if t in g.columns:
            out.append(f"{ind}m_{t}[(long long)k * ms_{t}] = c_{t};")
    return out + [f"{ind}kl_ = k;"]


def _column_loop(em: _Emitter, g: ColumnGroup, li: int, r: Extent) -> List[str]:
    """Loop ``li`` of a fused column kernel, each section a K loop that
    loads the inputs its unconditional statements read one level ahead,
    into registers, before the level's arithmetic."""
    st = em.stencil
    order, secs = g.loops[li]
    em.col_loop = li
    fwd = order == ir.LoopOrder.FORWARD
    step = 1 if fwd else -1
    ind = "      "
    out = ["  {", f"    int kl_ = {'-2147483647' if fwd else '2147483646'};", "    (void)kl_;"]
    for sid, stmts in secs:
        keys = g.prefetch.get(sid, [])
        em.pf = {}
        lo, hi = f"kb.lo[{sid}]", f"kb.hi[{sid}]"
        first = lo if fwd else f"{hi} - 1"
        loads = []
        for n, (name, oi, oj, ok) in enumerate(keys):
            dt = np.dtype(st.decl(name).dtype)
            acc = ir.FieldAccess(name, offset=ir.CartesianOffset(oi, oj, ok))
            load = f"m_{name}[(long long)(k_ + {ok}) * ms_{name}]" if name in g.columns \
                else em.global_access(acc, k="k_")
            if dt in _HALF and name not in g.columns:
                load = f"{_HALF[dt][0]}({load})"
            loads.append((n, _ctype(dt), load))
        out.append("    {")
        for n, ct, load in loads:
            out.append(f"      {ct} n{n}_ = ({ct})0;")
        if loads:
            out.append(f"      if ({lo} < {hi}) {{ const int k_ = {first}; "
                       + " ".join(f"n{n}_ = {ld};" for n, _, ld in loads) + " }")
        out.append("  " + _k_loop(order, sid, "    "))
        for n, ct, _ in loads:
            out.append(f"{ind}const {ct} v{n}_ = n{n}_;")
            em.pf[keys[n]] = f"v{n}_"
        if loads:
            nxt = f"k + {step}"
            out.append(f"{ind}if ({nxt} >= {lo} && {nxt} < {hi}) {{ const int k_ = {nxt}; "
                       + " ".join(f"n{n}_ = {ld};" for n, _, ld in loads) + " }")
        out += _column_level(em, g, li, stmts, r, step, ind)
        out += ["    }", "    }"]
        em.pf = {}
    return out + ["  }"]


def _emit_column_group(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The fused column kernel of a run of serial loops (``ColumnGroup``):
    thread (j, i) owns one column through every loop, J along
    ``threadIdx.x``.  A carried temporary is two registers, the level's
    (``c_``) and the one before in the sweep (``p_``, zero where that
    level was not swept); a whole-column one is also stored at every
    level its loop sweeps, into its device-memory scratch."""
    g = p.group
    r = p.rect
    out = [
        "",
        f"// {p.name}: fused column form ({' + '.join(o.name for o, _ in g.loops)}), "
        f"{COL_THREADS} columns a CTA, rect I{r.i} J{r.j}; carried {g.carries}, whole-column "
        f"{g.columns}; ~{bpp} bytes per grid point",
        f"__global__ void __launch_bounds__({COL_THREADS}, {COL_MIN_CTAS}) {p.name}(",
        "    " + ",\n    ".join(params) + ") {",
        f"  const int j = {r.j[0]} + (int)(blockIdx.x * blockDim.x + threadIdx.x);",
        f"  const int i = {r.i[0]} + (int)blockIdx.y;",
        f"  if (i >= dI + {r.i[1]} || j >= dJ + {r.j[1]}) return;",
    ]
    out += _column_heads(em, g, "i", "j", "  ")
    out += _hoist_registers(em, [s for _, stmts in p.sections for s in stmts], set(p.writes),
                            r, "  ")
    em.col = g
    for li in range(len(g.loops)):
        out += _column_loop(em, g, li, r)
    em.col = None
    em.hoisted = {}
    return out + ["}"]


def _emit_sweep(em: _Emitter, p: KernelPlan, params: List[str], bpp: int) -> List[str]:
    """The sweep kernel (``SweepPlan``) of a serialized PARALLEL loop and
    the serial loops after it: one CTA of TI TJ threads per tile, thread
    t owning column (I0 + t / TJ, J0 + t % TJ).  Step k_ of the sweep runs
    the plane part at level k_ + lead (its stages over the tile as the
    plane-sweep form runs a plane, its inputs staged a level ahead), then
    the first column loop's sections at level k_ in each thread's column
    (its carries in registers, its whole-column temporaries stored once a
    level), reading what the plane part wrote at its own points from the
    shared ring; the later loops run after the sweep, as the fused column
    kernel runs them.  The sweep's steps span every level either part
    sweeps; ``gt_run`` launches it only where each loop's sections are
    ordered along K (``CudaBackend._launch``)."""
    sp = p.sweep
    pp = p.planes
    g = p.group
    TI, TJ = sp.tile
    T = sp.threads
    st = em.stencil
    locals_ = em.locals
    psecs = sp.plane_secs
    csecs = g.loops[0][1]
    staged = [f"{n}@k{dk}" for n, dk, *_ in sp.inputs]
    out = [
        "",
        f"// {p.name}: sweep form (the serialized PARALLEL loop {psecs} and "
        f"{' + '.join(o.name for o, _ in g.loops)}), tile {TI}x{TJ}, {T} threads, a column "
        f"each; plane part {sp.lead} levels ahead, ring {sp.ring}, shared {sorted(pp.shared)} "
        f"in {len(sp.slot_bytes)} slots, staged {staged}; carried {g.carries}, whole-column "
        f"{g.columns}; {sp.smem_bytes} shared bytes; ~{bpp} bytes per grid point",
        f"__global__ void __launch_bounds__({T}) {p.name}(",
        "    " + ",\n    ".join(params) + ") {",
        "  GT_DYNAMIC_SMEM(gt_smem);",
    ]
    offs, at = [], 0
    for b in sp.slot_bytes:
        offs.append(at)
        at += b
    for name in pp.shared:
        ct = _ctype(st.decl(name).dtype)
        out.append(f"  {ct}* const sh_{name} = ({ct}*)(gt_smem + {offs[sp.slot[name]]});")
    for name, depth in sp.ring.items():
        ct = _ctype(st.decl(name).dtype)
        out.append(f"  {ct}* const sr_{name} = ({ct}*)(gt_smem + {at});")
        at += _align16(depth * T * _value_size(st.decl(name).dtype))
    ring = at
    out += _tile_origin(TI, TJ) + [
        "  const int ct_ = (int)threadIdx.x;",
        f"  const int ci_ = I0 + ct_ / {TJ}, cj_ = J0 + ct_ % {TJ};",
        "  const bool col_ = ci_ < I1 && cj_ < J1;",
        "  (void)ct_; (void)col_;",
    ]
    out += _column_heads(em, g, "ci_", "cj_", "  ")
    fwd = p.order == ir.LoopOrder.FORWARD
    out += [f"  int kl_ = {'-2147483647' if fwd else '2147483646'};", "  (void)kl_;",
            "  // the steps: every level the plane part sweeps, less its lead, and every "
            "level the first column loop sweeps",
            "  int ks_ = 2147483647, ke_ = -2147483647;"]
    for sid, lead in [(sid, sp.lead) for sid in psecs] + [(sid, 0) for sid, _ in csecs]:
        lo, hi = f"kb.lo[{sid}] - {lead}", f"kb.hi[{sid}] - {lead}"
        out.append(f"  if (kb.lo[{sid}] < kb.hi[{sid}]) {{ if ({lo} < ks_) ks_ = {lo}; "
                   f"if ({hi} > ke_) ke_ = {hi}; }}")
    em.threads = T
    if sp.inputs:
        (sid0,) = psecs
        out += _staged_row_pitches(em, sp.inputs)
        out += _emit_staging(em, sp.tile, sp.inputs, ring, sp.input_bytes)
        out += [f"  if (kb.lo[{sid0}] < kb.hi[{sid0}]) stage_(kb.lo[{sid0}], 0);",
                "  gt::async_commit();"]
    live = " || ".join(f"(k >= kb.lo[{sid}] && k < kb.hi[{sid}])" for sid in psecs)
    out += ["  for (int k_ = ks_; k_ < ke_; ++k_) {",
            "    {",
            f"      const int k = k_ + {sp.lead};",
            f"      if ({live}) {{"]
    body = []
    if sp.inputs:
        body += [f"    const int s_ = (k - kb.lo[{sid0}]) & 1;",
                 f"    if (k + 1 < kb.hi[{sid0}]) stage_(k + 1, s_ ^ 1);",
                 "    gt::async_commit();",
                 "    gt::async_wait<1>();",
                 "    __syncthreads();"]
        body += _staged_pointers(em, sp.tile, sp.inputs, ring, sp.input_bytes, "    ")
    em.plane = pp
    em.locals = set(pp.registers)
    em.plane_order = p.order
    em.done_secs = []
    em.ring = dict(sp.ring)
    em.ring_cols = T
    em.ring_tile = sp.tile
    em.tin = {(name, dk): (e, pitch, lanes) for name, dk, e, pitch, lanes in sp.inputs}
    for sid in psecs:
        em.sid = sid
        lines = _plane_level(em, p, sid)
        if len(psecs) > 1:
            lines = [f"    if (k >= kb.lo[{sid}] && k < kb.hi[{sid}]) {{"] + \
                ["  " + ln for ln in lines] + ["    }"]
        body += lines
        em.done_secs.append(sid)
    em.tin = {}
    em.plane = None
    em.locals = locals_
    em.threads = PLANE_THREADS
    out += ["    " + ln for ln in body]
    out += ["      }", "    }"]
    # the first column loop at level k_, in the thread's column
    em.col = g
    em.col_loop = 0
    em.plane_secs = psecs
    step = 1 if fwd else -1
    out += ["    if (col_) {",
            "      const int i = ci_, j = cj_, k = k_;"]
    for sid, stmts in csecs:
        out.append(f"      if (k >= kb.lo[{sid}] && k < kb.hi[{sid}]) {{")
        out += _column_level(em, g, 0, stmts, Extent(), step, "        ")
        out.append("      }")
    out += ["    }", "    __syncthreads();", "  }"]
    em.ring = {}
    # the later loops, in the thread's column, after the sweep
    if len(g.loops) > 1:
        out += ["  if (col_) {", "  const int i = ci_, j = cj_;"]
        for li in range(1, len(g.loops)):
            out += _column_loop(em, g, li, Extent())
        out.append("  }")
    em.col = None
    return out + ["}"]


def _emit_snapshot(name: str, kernel: str, ctype: str) -> List[str]:
    """The copy of a field's accessed box into its snapshot."""
    return [
        "",
        f"// {kernel}: the copy of '{name}' a plane-sweep kernel reads ahead",
        f"__global__ void __launch_bounds__({BLOCK_J * BLOCK_I}) {kernel}(",
        f"    gt::Field<{ctype}> dst, gt::Field<{ctype}> src, int i0, int i1, int j0, int j1) {{",
        "  const int j = j0 + (int)(blockIdx.x * blockDim.x + threadIdx.x);",
        "  const int i = i0 + (int)(blockIdx.y * blockDim.y + threadIdx.y);",
        "  if (i >= i1 || j >= j1) return;",
        "  for (int k = src.klo; k <= src.khi; ++k) dst.at(i, j, k) = src.at(i, j, k);",
        "}",
    ]


def _snapshot_copies(p: KernelPlan, args: List[str], snapshots) -> List[str]:
    """gt_run's copies of the fields a plane-sweep or sweep kernel reads
    ahead, into their snapshots, before the kernel."""
    out = []
    for n in p.planes.snapshots:
        kernel, src, e = snapshots[n]
        out += [
            "  {",
            f"    const int ni = dI + {e.i[1] - e.i[0]}, nj = dJ + {e.j[1] - e.j[0]};",
            "    if (ni > 0 && nj > 0) {",
            f"      const dim3 grid((nj + {BLOCK_J - 1}) / {BLOCK_J}, "
            f"(ni + {BLOCK_I - 1}) / {BLOCK_I}), block({BLOCK_J}, {BLOCK_I});",
            f"      {kernel}<<<grid, block, 0, st>>>(o_{n}, {src}, {e.i[0]}, dI + {e.i[1]}, "
            f"{e.j[0]}, dJ + {e.j[1]});",
            "      ++gt_launches_; ++gt_copy_launches_;",
            "      const cudaError_t e = cudaGetLastError();",
            "      if (e != cudaSuccess) return (int)e;",
            "    }",
            "  }",
        ]
    return out


def _launch_lines(p: KernelPlan, index: int, args: List[str], nsec: int,
                  snapshots: Dict[str, Tuple[str, str, Extent]] = None,
                  vk_base: int = 0) -> List[str]:
    """gt_run's launch of one kernel (K4's variant when the kernel has a
    window and ``kmode`` is set; a plane-sweep kernel's snapshots are
    copied first).
    ``snapshots``: name -> (copy kernel, source variable, box extent);
    ``vk_base``: a staged kernel's first window in ``vks``."""
    call = ", ".join(args)
    check = [f"      ++gt_launches_; ++gt_kernel_launches_[{index}];",
             "      const cudaError_t e = cudaGetLastError();",
             "      if (e != cudaSuccess) return (int)e;"]

    def attr(kernel: str, ind: str) -> List[str]:
        return [f"{ind}if (smem > {SMEM_DEFAULT}) {{",
                f"{ind}  const cudaError_t a = cudaFuncSetAttribute({kernel}, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);",
                f"{ind}  if (a != cudaSuccess) return (int)a;",
                f"{ind}}}"]

    if p.vark is not None:
        vp = p.vark
        TI, TJ = vp.tile
        ((sid, _),) = p.sections
        nf = len(vp.fields)
        return [
            "  {",
            f"    const int ni = dI + {p.rect.i[1] - p.rect.i[0]}, "
            f"nj = dJ + {p.rect.j[1] - p.rect.j[0]}, nk_ = kb.hi[{sid}] - kb.lo[{sid}];",
            f"    gt::Slots<{nf}> vs_;",
            "    size_t smem = 0;",
            f"    for (int f = 0; f < {nf}; ++f) vs_.s[f] = vks[{vk_base} + f];",
            *[f"    smem += ((size_t)vs_.s[{n}] * {vp.level_bytes(n)} + 15) / 16 * 16;"
              for n in range(nf)],
            "    if (ni > 0 && nj > 0 && nk_ > 0) {",
            f"      const dim3 grid((nj + {TJ - 1}) / {TJ}, (ni + {TI - 1}) / {TI}), "
            f"block({TI * TJ * vp.lanes});",
            *attr(p.name, "      "),
            f"      {p.name}<<<grid, block, smem, st>>>({call}, vs_, "
            f"(unsigned long long*)vko + {index});",
            *check,
            "    }",
            "  }",
        ]

    if p.swept_by is not None:
        # replaced by the sweep kernel but under K4 (the plane kernel) and
        # where a call's sections are not ordered along K
        cond = f"kmode || !vec[{p.swept_by}]" if p.group is None else f"!kmode && !vec[{p.swept_by}]"
        lines = _launch_lines(replace(p, swept_by=None), index, args, nsec, snapshots)
        if p.group is not None:
            lines = lines[1:-1]  # its own "if (!kmode)" block
        return [f"  if ({cond}) {{", *lines, "  }"]
    if p.sweep is not None:
        TI, TJ = p.sweep.tile
        return _snapshot_copies(p, args, snapshots) + [
            f"  if (!kmode && vec[{index}]) {{",
            f"    const dim3 grid((dJ + {TJ - 1}) / {TJ}, (dI + {TI - 1}) / {TI}), "
            f"block({p.sweep.threads});",
            f"    const size_t smem = {p.sweep.smem_bytes};",
            "    if (dI > 0 && dJ > 0) {",
            *attr(p.name, "      "),
            f"      {p.name}<<<grid, block, smem, st>>>({call});",
            *check,
            "    }",
            "  }",
        ]
    if p.group is not None:
        # one pass (no K4): the fused kernel
        return [
            "  if (!kmode) {",
            f"    const int ni = dI + {p.rect.i[1] - p.rect.i[0]}, "
            f"nj = dJ + {p.rect.j[1] - p.rect.j[0]};",
            "    if (ni > 0 && nj > 0) {",
            f"      const dim3 grid((nj + {COL_THREADS - 1}) / {COL_THREADS}, ni), "
            f"block({COL_THREADS});",
            f"      {p.name}<<<grid, block, 0, st>>>({call});",
            *check,
            "    }",
            "  }",
        ]
    if p.planes is not None:
        TI, TJ = p.planes.tile
        copies = _snapshot_copies(p, args, snapshots)
        if p.tile is not None:
            ((sid, _),) = p.sections
            # vec[index]: the call's staged rows all on one lead (the twin)
            launch = [*attr(p.name, "      "), f"      {p.name}<<<grid, block, smem, st>>>({call});"]
            if any(lanes for *_, lanes in p.tile.inputs):
                launch = [f"      if (vec[{index}]) {{", *["  " + ln for ln in attr(
                    p.name + "_u", "      ")],
                          f"        {p.name}_u<<<grid, block, smem, st>>>({call});",
                          "      } else {", *["  " + ln for ln in launch], "      }"]
            return copies + [
                "  {",
                f"    const int nk_ = kb.hi[{sid}] - kb.lo[{sid}];",
                f"    const dim3 grid((dJ + {TJ - 1}) / {TJ}, (dI + {TI - 1}) / {TI}, "
                f"(nk_ + {p.tile.kz - 1}) / {p.tile.kz}), block({PLANE_THREADS});",
                f"    const size_t smem = {p.tile.smem_bytes};",
                "    if (dI > 0 && dJ > 0 && nk_ > 0) {",
                *launch,
                *check,
                "    }",
                "  }",
            ]
        launch = [*attr(p.name, "      "), f"      {p.name}<<<grid, block, smem, st>>>({call});",
                  *check]
        if p.planes.per_level:
            # one launch a level, in the loop's order, each on its level of
            # every section (``PlanePlan.per_level``)
            sids = [sid for sid, _ in p.sections]
            level = "lo_ + l_" if p.order == ir.LoopOrder.FORWARD else "hi_ - 1 - l_"
            kcall = ", ".join("kl_" if a == "kb" else a for a in args)
            launch = [
                *attr(p.name, "      "),
                f"      int lo_ = kb.lo[{sids[0]}], hi_ = kb.hi[{sids[0]}];",
                *[f"      lo_ = kb.lo[{s}] < lo_ ? kb.lo[{s}] : lo_; "
                  f"hi_ = kb.hi[{s}] > hi_ ? kb.hi[{s}] : hi_;" for s in sids[1:]],
                "      for (int l_ = 0; l_ < hi_ - lo_; ++l_) {",
                f"        const int lv_ = {level};",
                "        gt::KBounds<" + str(nsec) + "> kl_ = kb;",
                *[f"        kl_.lo[{s}] = kb.lo[{s}] > lv_ ? kb.lo[{s}] : lv_; "
                  f"kl_.hi[{s}] = kb.hi[{s}] < lv_ + 1 ? kb.hi[{s}] : lv_ + 1;" for s in sids],
                f"        {p.name}<<<grid, block, smem, st>>>({kcall});",
                *["  " + ln for ln in check],
                "      }",
            ]
        return copies + [
            "  {",
            f"    const dim3 grid((dJ + {TJ - 1}) / {TJ}, (dI + {TI - 1}) / {TI}), "
            f"block({PLANE_THREADS});",
            f"    const size_t smem = {p.planes.smem_bytes};",
            "    if (dI > 0 && dJ > 0) {",
            *launch,
            "    }",
            "  }",
        ]
    ni = f"dI + {p.rect.i[1] - p.rect.i[0]}"
    nj = f"dJ + {p.rect.j[1] - p.rect.j[0]}"
    plain = [
        "    if (ni > 0 && nj > 0) {",
        f"      const dim3 grid((nj + {BLOCK_J - 1}) / {BLOCK_J}, "
        f"(ni + {BLOCK_I - 1}) / {BLOCK_I}), block({BLOCK_J}, {BLOCK_I});",
        f"      {p.name}<<<grid, block, 0, st>>>({call});",
        *check,
        "    }",
    ]
    out = ["  {", f"    const int ni = {ni}, nj = {nj};"]
    if p.vector is not None:
        # vec[index] - 1: the phase of the J points that start 16-byte
        # words; the first group starts at or before the rectangle
        V = p.vector.V
        vcall = f"{call}, vj0, vng"
        return out + [
            f"    if (vec[{index}] > 0) {{",
            f"      const int ph = vec[{index}] - 1, lo = {p.rect.j[0]};",
            f"      const int vj0 = lo - (((lo - ph) % {V}) + {V}) % {V};",
            f"      const int vng = (dJ + {p.rect.j[1]} - vj0 + {V - 1}) / {V};",
            "      if (ni > 0 && vng > 0) {",
            f"        const dim3 grid((vng + {VBLOCK_J - 1}) / {VBLOCK_J}, "
            f"(ni + {VBLOCK_I - 1}) / {VBLOCK_I}, {VSPLIT_K}), block({VBLOCK_J}, {VBLOCK_I});",
            f"        {p.name}_v<<<grid, block, 0, st>>>({vcall});",
            f"        ++gt_launches_; ++gt_kernel_launches_[{index}]; "
            f"++gt_vec_launches_[{index}];",
            "        const cudaError_t e = cudaGetLastError();",
            "        if (e != cudaSuccess) return (int)e;",
            "      }",
            "    } else {",
            *["  " + ln for ln in plain],
            "    }",
            "  }",
        ]
    if p.k4_only:
        # the fused kernel runs the loop in one pass: only K4 launches it
        if p.window is None:
            return []
        plain = []
    if p.window is None:
        return out + plain + ["  }"]
    w = p.window
    kcall = f"{call}, KB"
    out += [
        f"    const int KB = kmode ? kbsz[{index}] : 0;",
        "    if (KB > 0 && ni > 0 && nj > 0) {",
        f"      const dim3 grid((nj + {KB_TILE_J - 1}) / {KB_TILE_J}, "
        f"(ni + {KB_TILE_I - 1}) / {KB_TILE_I}), block({KB_TILE_J}, {KB_TILE_I});",
        f"      const size_t {', '.join(_window_sizes(w))};",
        f"      size_t smem = {w.slots} * slot_;",
        "      if (smem < 16) smem = 16;",
        *attr(f"{p.name}_kb", "      "),
        f"      {p.name}_kb<<<grid, block, smem, st>>>({kcall});",
        f"      ++gt_kb_launches_[{index}];",
        *check,
        "    } else {",
        *["  " + ln for ln in plain],
        "    }",
        "  }",
    ]
    return out


def _occupancy_lines(plans: List[KernelPlan]) -> List[str]:
    """``gt_kb_init``: the largest shared-memory carveout for every K4
    kernel, so that several of its CTAs share a SM (by default more of it
    may stay L1 cache), set once per device before the first K4 launch.
    ``gt_kb_occupancy``: the CTAs a SM holds of each K4 kernel at the
    block sizes ``kbsz`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    after the launch's attributes), into ``out`` by kernel index."""
    out = ['extern "C" int gt_kb_init() {']
    for p in plans:
        if p.window is not None:
            out += ["  {",
                    f"    const cudaError_t a = cudaFuncSetAttribute({p.name}_kb, "
                    "cudaFuncAttributePreferredSharedMemoryCarveout, "
                    "cudaSharedmemCarveoutMaxShared);",
                    "    if (a != cudaSuccess) return (int)a;",
                    "  }"]
    out += ["  return 0;", "}", "",
            'extern "C" int gt_kb_occupancy(const int* kbsz, int* out) {']
    for index, p in enumerate(plans):
        if p.window is None:
            continue
        w = p.window
        out += [
            "  {",
            f"    const int KB = kbsz[{index}];",
            f"    const size_t {', '.join(_window_sizes(w))};",
            f"    size_t smem = {w.slots} * slot_;",
            "    if (smem < 16) smem = 16;",
            f"    if (smem > {SMEM_DEFAULT}) {{",
            f"      const cudaError_t a = cudaFuncSetAttribute({p.name}_kb, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);",
            "      if (a != cudaSuccess) return (int)a;",
            "    }",
            f"    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor("
            f"&out[{index}], {p.name}_kb, {KB_TILE_I * KB_TILE_J}, smem);",
            "    if (e != cudaSuccess) return (int)e;",
            "  }",
        ]
    return out + ["  return 0;", "}", ""]


def generate(analysis: StencilAnalysis, serialize: Optional[bool] = None,
             k_blocked: Optional[bool] = None, tiles: Optional[bool] = None,
             fuse_loops: Optional[bool] = None, sweep: Optional[bool] = None,
             stage_vark: Optional[bool] = None, held: frozenset = frozenset()) -> CudaProgram:
    """Emit the CUDA C++ source of one stencil (deterministic).
    ``serialize``, ``k_blocked``, ``tiles``, ``fuse_loops``, ``sweep`` and
    ``stage_vark``: the build options (see ``plan_stencil``,
    ``plan_kernels`` and ``CudaProgram.kblock_plan``).  An ``if`` or a
    region that reads a field it writes at an offset is split first
    (``passes.split_compound_statements``), so that stages may part its
    statements.  ``held``: temporaries the caller allocates and passes
    with the fields (a phased call on DistributedFields holds them across
    its stencils): each stays in device memory, in no register or shared
    plane only, so that the kernels read and leave their values there."""
    _check_supported(analysis)
    split = passes.split_compound_statements(analysis)
    if split is not None:
        analysis = analyze(*split, validate=False)
    held = frozenset(held)
    planned, plans, serialized, declined = plan_stencil(analysis, serialize, tiles, fuse_loops,
                                                        sweep, stage_vark, held)
    st = planned.stencil
    touching = {n: [p for p in plans if n in p.reads or n in p.writes] for n in st.temp_decls}
    planes_global = {n for n, ps in touching.items() for p in ps
                     if p.planes is not None and p.sweep is None and _in_device_memory(p, n, ())}
    locals_ = [n for n in _local_temps(planned, [p for p in plans
                                                 if p.planes is None and p.group is None])
               if n not in planes_global and n not in held]
    for p in plans:
        if p.group is not None:
            _plan_group(planned, p, [*locals_, *held])
    scratch = [n for n, ps in touching.items()
               if not ps or any(_in_device_memory(p, n, locals_) for p in ps)]
    fields = list(st.field_decls)
    snapshots = sorted({n for p in plans if p.planes for n in p.planes.snapshots})
    scalars = [n for n, p in analysis.parameter_info.items() if p.access.value & 1]
    float_scalars = [n for n in scalars if is_float_dtype(st.scalar_decls[n].dtype)]
    int_scalars = [n for n in scalars if n not in float_scalars]
    intervals = [s.interval for loop in st.vertical_loops for s in loop.sections]
    nsec = len(intervals)
    em = _Emitter(planned, locals_)
    kb_reason, kb_passes, kb_promoted = (
        _kblock_eligibility(planned, plans) if k_blocked is not False else
        ("k_blocked=False", 0, []))
    for p in plans:
        if p.form == "rows":
            p.vector = _plan_vector(planned, p, locals_)
    if kb_reason is None:
        for p in plans:
            if p.form == "columns":
                p.window = _plan_window(planned, p, locals_)
    # the default: one pass where ``kb_default`` says (``kblock_plan``)
    declined_deep = kb_reason
    if k_blocked is None:
        declined["kblocked"] = KB_DEFAULT_ONE_PASS
    elif kb_reason is not None:
        declined["kblocked"] = kb_reason

    params = (
        [f"gt::Field<{_stype(st.field_decls[n].dtype)}> f_{n}" for n in fields]
        + [f"gt::Field<{_stype(st.temp_decls[n].dtype)}> t_{n}" for n in scratch]
        + [f"gt::Field<{_stype(st.decl(n).dtype)}> o_{n}" for n in snapshots]
        + ["int dI", "int dJ", "int dK", "int pI", "int pJ", f"gt::KBounds<{nsec}> kb"]
        + (["int gI0", "int gJ0", "int gNI", "int gNJ"] if em.framed else [])
        + [f"{_ctype(st.scalar_decls[n].dtype)} s_{n}" for n in scalars]
    )
    args = [f"f_{n}" for n in fields] + [f"t_{n}" for n in scratch] + [
        f"o_{n}" for n in snapshots] + ["dI", "dJ", "dK", "pI", "pJ", "kb"] + (
        ["gI0", "gJ0", "gNI", "gNJ"] if em.framed else []) + [f"s_{n}" for n in scalars]
    snap = {n: (f"{st.name}_snap_{n}", ("f_" if n in st.field_decls else "t_") + n,
                planned.extents.alloc_extent(n)) for n in snapshots}

    bpp = {p.name: _bytes_per_point(planned, p, [n for n in p.reads + p.writes
                                                  if not _in_device_memory(p, n, locals_)])
           for p in plans}
    notes = [REPLACES["rows"], REPLACES["columns"], REPLACES["wrap"]]
    if any(p.form == "planes" for p in plans):
        notes.append(REPLACES["planes"])
    if any(p.sweep for p in plans):
        notes.append(REPLACES["sweep"])
    if any(p.window for p in plans):
        notes.append(REPLACES["kblocked"])
    if any(p.vector for p in plans):
        notes.append(REPLACES["repair"])
    out = [
        f"// Stencil '{st.name}': generated by gt4py_tpu_torch.cartesian.backend."
        "cuda_backend.",
        "// Replaces the TPU kernels of the JAX package:",
        *[f"//   {n}" for n in notes],
        "// Bound on the H100: device-memory bandwidth (3.35 TB/s).  Each kernel",
        "// does a few flops per byte it moves; its bytes per grid point are noted",
        "// at the kernel.  Design: one thread per (i, j) point or column, J along",
        "// threadIdx.x for coalesced loads, K looped inside the thread, periodic",
        "// reads wrapped in the load address; a plane-sweep kernel is one CTA per",
        "// (I, J) tile sweeping K with its planes in shared memory; a row stage's",
        "// vector kernel (_v) computes V consecutive J points a thread with 16-byte",
        "// loads and stores at each row's phase, launched where its fields are J-contiguous.",
        '#include "stencil_runtime.cuh"',
        "",
        "namespace {",
        "",
        "// kernel launches gt_run has made, counted at each launch: in all,",
        "// by kernel index (each of its variants), of each kernel's K4 and",
        "// vector variants, and the snapshot copies: read by gt_launch_counts",
        "long long gt_launches_ = 0;",
        f"long long gt_kernel_launches_[{len(plans)}] = {{}};",
        f"long long gt_kb_launches_[{len(plans)}] = {{}};",
        f"long long gt_vec_launches_[{len(plans)}] = {{}};",
        "long long gt_copy_launches_ = 0;",
    ]
    for n in snapshots:
        out += _emit_snapshot(n, snap[n][0], _stype(st.decl(n).dtype))
    for p in plans:
        if p.sweep is not None:
            out += _emit_sweep(em, p, params, bpp[p.name])
            continue
        if p.tile is not None:
            out += _emit_tile(em, p, params, bpp[p.name])
            em.locals = set(locals_)
            continue
        if p.planes is not None:
            out += _emit_planes(em, p, params, bpp[p.name])
            em.locals = set(locals_)
            continue
        if p.group is not None:
            out += _emit_column_group(em, p, params, bpp[p.name])
            continue
        if p.vark is not None:
            out += _emit_vark(em, p, params, bpp[p.name])
            continue
        if not p.k4_only:
            out += _emit_plain_kernel(em, p, params, bpp[p.name])
        if p.vector is not None:
            out += _emit_vector_rows(em, p, params, bpp[p.name])
        if p.window is not None:
            out += _emit_window_kernel(em, p, params)
    out += ["", "}  // namespace", ""]

    # the launcher: one plain C entry point for ctypes; kmode 1 runs K4's
    # kernels with kbsz[kernel index] levels per block
    out += [
        'extern "C" int gt_run(void* const* ptrs, const long long* strides, '
        "const int* dom, const int* kbv,",
        "                      const double* fsc, const long long* isc, int pI, int pJ, "
        "void* stream, int kmode, const int* kbsz, const int* vec, const int* vks, "
        "void* vko) {",
    ]
    fvars = [(n, "f_" + n) for n in fields] + [(n, "t_" + n) for n in scratch] + [
        (n, "o_" + n) for n in snapshots]
    for b, (n, var) in enumerate(fvars):
        ct = _stype(st.decl(n).dtype)
        s = [f"strides[{_REC * b + x}]" for x in range(_REC)]
        sd = ", ".join(s[3:3 + MAX_DATA_DIMS])
        out.append(f"  const gt::Field<{ct}> {var}{{({ct}*)ptrs[{b}], {s[0]}, {s[1]}, {s[2]}, "
                   f"{{{sd}}}, (int){s[-4]}, (int){s[-3]}, (const unsigned char*){s[-2]}, "
                   f"(const unsigned char*){s[-1]}}};")
    out.append(f"  GT_STORAGES({', '.join(var for _, var in fvars)});")
    out += [
        "  const int dI = dom[0], dJ = dom[1], dK = dom[2];",
        *(["  const int gI0 = dom[3], gJ0 = dom[4], gNI = dom[5], gNJ = dom[6];"]
          if em.framed else []),
        f"  gt::KBounds<{nsec}> kb;",
        f"  for (int s = 0; s < {nsec}; ++s) {{ kb.lo[s] = kbv[2 * s]; kb.hi[s] = kbv[2 * s + 1]; }}",
    ]
    for n in scalars:
        ct = _ctype(st.scalar_decls[n].dtype)
        src = f"fsc[{float_scalars.index(n)}]" if n in float_scalars else \
            f"isc[{int_scalars.index(n)}]"
        out.append(f"  const {ct} s_{n} = ({ct}){src};")
    out += ["  cudaStream_t st = (cudaStream_t)stream;",
            "  (void)kmode; (void)kbsz; (void)vec; (void)vks; (void)vko;"]
    vk_base = 0
    for n, p in enumerate(plans):
        out += _launch_lines(p, n, args, nsec, snap, vk_base)
        vk_base += len(p.vark.fields) if p.vark else 0
    out += ["  return 0;", "}", "",
            'extern "C" const char* gt_error_string(int e) '
            "{ return cudaGetErrorString((cudaError_t)e); }", "",
            f"// out[0]: every kernel launch gt_run has made; for kernel n of {len(plans)}:",
            "// out[1 + n] its K4 launches, out[1 + N + n] all its launches,",
            "// out[1 + 2N + n] its vector row launches; out[1 + 3N] the snapshot copies",
            'extern "C" void gt_launch_counts(long long* out) {',
            "  out[0] = gt_launches_;",
            f"  for (int n = 0; n < {len(plans)}; ++n) {{",
            "    out[1 + n] = gt_kb_launches_[n];",
            f"    out[1 + {len(plans)} + n] = gt_kernel_launches_[n];",
            f"    out[1 + {2 * len(plans)} + n] = gt_vec_launches_[n];",
            "  }",
            f"  out[1 + {3 * len(plans)}] = gt_copy_launches_;",
            "}", ""]
    if any(p.window for p in plans):
        out += _occupancy_lines(plans)
    temp_events, irregular = _temp_events(planned, plans, set(scratch))
    return CudaProgram(
        source="\n".join(out),
        kernels=plans,
        fields=fields,
        scratch=scratch,
        locals=list(locals_),
        snapshots=snapshots,
        float_scalars=float_scalars,
        int_scalars=int_scalars,
        intervals=intervals,
        bytes_per_point=bpp,
        temp_events=temp_events,
        irregular_writes=irregular,
        section_order={sid: p.order for p in plans if p.group is None
                       for sid, _ in p.sections},
        analysis=planned,
        serialized=serialized,
        declined=declined,
        kb_passes=kb_passes,
        kb_promoted=kb_promoted,
        kb_default=k_blocked is None,
        kb_declined_deep=declined_deep,
        widened={n: e for p in plans if p.planes for n, e in p.planes.widened_fields.items()},
    )


# --------------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------------- #


def _j_contiguous(t: torch.Tensor) -> bool:
    """The view's J elements are adjacent in memory (its rows can be read
    as 16-byte words from any phase); a J axis of one element broadcasts
    (``_field_arg`` gives it stride 0)."""
    return t.shape[1] > 1 and t.stride(1) == 1


def _no_overlap(t: torch.Tensor) -> bool:
    """True when no two elements of the view share memory: in the order of
    increasing stride, each stride passes the span of the axes before it
    (any axis order, gaps allowed, size-1 axes ignored; an expanded view
    fails)."""
    span = 0
    for s, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if s <= span:
            return False
        span += s * (n - 1)
    return True


def _field_arg(view: torch.Tensor, origin) -> Tuple[int, List[int]]:
    """Base pointer at the domain origin and the per-field record of a
    logical (I, J, K, *data_dims) view: element strides (size-1 spatial
    axes broadcast with stride 0), data strides, the buffer's K range
    in domain-relative levels, and its storage's byte range."""
    strides = [0 if n == 1 else s for s, n in zip(view.stride()[:3], view.shape[:3])]
    org = [0 if n == 1 else o for o, n in zip(origin, view.shape[:3])]
    offset = sum(o * s for o, s in zip(org, strides))
    data = list(view.stride()[3:])
    data += [0] * (MAX_DATA_DIMS - len(data))
    klo, khi = -org[2], view.shape[2] - 1 - org[2]
    storage = view.untyped_storage()
    s0 = storage.data_ptr()
    return view.data_ptr() + offset * view.element_size(), strides + data + [
        klo, khi, s0, s0 + storage.nbytes()]


@register("cuda")
class CudaBackend:
    """Generated CUDA kernels for CUDA tensors, the plain executor for CPU
    tensors.  ``launches`` counts the calls that launched the kernels,
    ``derivative_calls`` those of them that ran under K8 (``autodiff``)."""

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        options = options or {}
        self.analysis = analysis
        #: build options: ``serialize`` (K5, see ``plan_stencil``; None
        #: serializes mixed stencils, True any with a PARALLEL loop, False
        #: none), ``k_blocked`` (K4: True blocks the column loops),
        #: ``tiles`` (K1: None the tile form where it plans, True it or
        #: raise, False the stage-split row kernels) and ``fuse_loops``
        #: (K2: None fuses consecutive column loops where legal, True or
        #: raise, False one kernel per loop) and ``sweep`` (K5: True sweeps
        #: a serialized PARALLEL loop with the serial loops after it in one
        #: kernel or raises; None and False never) and ``stage_vark`` (K3:
        #: None the staged form where it plans, True it or raise, False the
        #: row kernels' loads from device memory)
        self.program = generate(analysis, serialize=options.get("serialize"),
                                k_blocked=options.get("k_blocked"),
                                tiles=options.get("tiles"),
                                fuse_loops=options.get("fuse_loops"),
                                sweep=options.get("sweep"),
                                stage_vark=options.get("stage_vark"),
                                held=options.get("held", frozenset()))
        LAST_PLAN[analysis.stencil.name] = self.program.plan_record()
        #: K6's launch options: ``vector`` (None: ``VECTOR_DEFAULT``, the
        #: vector row kernels wherever their fields share a 16-byte phase;
        #: True runs them, repairing a call whose fields share none, or
        #: raises; False never) and ``repair`` (None and False: never, as the
        #: tile kernels' staging needs no phase; True on every non-periodic
        #: call whose fields share no 16-byte phase, or raises)
        self.vector_opt = options.get("vector")
        self.repair_opt = options.get("repair")
        #: K8's option ``derivative``: None runs the derivative stencils
        #: (``derivative``) for CUDA tensors and the plain executor's re-run
        #: for CPU ones, ``"kernels"`` the derivative stencils on any device
        #: (a stencil the transform declines raises)
        self.derivative_opt = options.get("derivative")
        if self.derivative_opt not in (None, "kernels"):
            raise ValueError(f"derivative={self.derivative_opt!r}: None or 'kernels'")
        #: the derivative stencils are built with the forward's kernel forms
        #: and its ``derivative`` (a derivative of theirs, under nested
        #: transforms, follows the same rule)
        self._derivative_options = {k: v for k, v in options.items() if k in (
            "serialize", "k_blocked", "tiles", "fuse_loops", "sweep", "stage_vark", "vector",
            "repair", "derivative")}
        self._derivatives: Dict[tuple, object] = {}
        #: ``LAST_PLAN[name]["adjoint"]`` / ``["tangent"]``: the derivative
        #: stencil built for the last derivative call, or why it declined
        self.derivative_plan: Dict[str, dict] = {}
        #: derivative calls that ran the adjoint or tangent stencil, and
        #: those that asked for one the transform declined
        self.adjoint_calls = 0
        self.tangent_calls = 0
        self.derivative_declines = 0
        #: derivative calls whose backward or jvp re-ran the plain executor
        self.plain_reruns = 0
        self.plain = TorchExecutor(analysis)
        self.launches = 0
        #: calls that launched a vector row kernel or staged an input at
        #: its rows' phase with 16-byte copies, and calls that were repaired
        self.vector_launches = 0
        self.repairs = 0
        self.derivative_calls = 0
        self.build_seconds: Optional[float] = None
        self.build_dir: Optional[str] = None
        self._lib = None
        #: per device: each kernel's count of staged-form reads that fell
        #: outside their window (``outside_reads``)
        self._outside: Dict[torch.device, torch.Tensor] = {}
        self._depth_plans: Dict[tuple, tuple] = {}
        #: devices on which the K4 kernels' attributes are set (``gt_kb_init``)
        self._kb_devices: set = set()
        self._written = [
            n for n, info in analysis.field_info.items() if info.access.value & 2
        ]

    @property
    def source(self) -> str:
        return self.program.source

    def derivative(self, kind: str, wanted: Sequence[str], dK: Optional[int] = None,
                   periodic: Sequence[str] = ()):
        """K8's derivative stencil of ``kind`` (``"adjoint"``, on ``dK``
        levels and periodic on ``periodic``, or ``"tangent"``) for the
        inputs ``wanted``: ``(derivative.Derivative, CudaBackend)``, built
        at the first call for each key.  Raises ``derivative.Declined``
        with the transform's reason; the plan of each call goes into
        ``derivative_plan`` and ``LAST_PLAN[name][kind]``."""
        key = (kind, tuple(wanted)) + ((int(dK), tuple(periodic)) if kind == "adjoint" else ())
        hit = self._derivatives.get(key)
        if hit is None:
            try:
                d = derivative.adjoint_stencil(self.analysis, wanted, dK, periodic) \
                    if kind == "adjoint" else derivative.tangent_stencil(self.analysis, wanted)
                hit = (d, CudaBackend(d.analysis, self._derivative_options))
            except derivative.Declined as e:
                hit = e
            self._derivatives[key] = hit
        if isinstance(hit, Exception):
            self.derivative_declines += 1
            rec = {"declined": str(hit), "wanted": list(wanted)}
        else:
            name = hit[0].stencil.name
            rec = {"stencil": name, "wanted": list(wanted),
                   "forms": LAST_PLAN.get(name, {}).get("forms")}
        self.derivative_plan[kind] = rec
        LAST_PLAN.setdefault(self.analysis.stencil.name, {})[kind] = rec
        if isinstance(hit, Exception):
            raise hit
        return hit

    def derivative_backends(self) -> Dict[str, List["CudaBackend"]]:
        """The derivative stencils built so far, by kind."""
        out: Dict[str, List[CudaBackend]] = {"adjoint": [], "tangent": []}
        for key, hit in self._derivatives.items():
            if not isinstance(hit, Exception):
                out[key[0]].append(hit[1])
        return out

    def build(self):
        """Compile (or load) the kernels; returns the ctypes library."""
        if self._lib is None:
            t0 = time.perf_counter()
            lib, self.build_dir = _build.build(self.program.source, self.analysis.stencil.name)
            lib.gt_run.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                           ctypes.c_void_p, ctypes.c_int,
                                                           ctypes.c_void_p, ctypes.c_void_p,
                                                           ctypes.c_void_p, ctypes.c_void_p]
            lib.gt_run.restype = ctypes.c_int
            lib.gt_error_string.argtypes = [ctypes.c_int]
            lib.gt_error_string.restype = ctypes.c_char_p
            lib.gt_launch_counts.argtypes = [ctypes.c_void_p]
            lib.gt_launch_counts.restype = None
            if any(k.window for k in self.program.kernels):
                lib.gt_kb_init.argtypes = []
                lib.gt_kb_init.restype = ctypes.c_int
                lib.gt_kb_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                lib.gt_kb_occupancy.restype = ctypes.c_int
            self._lib = lib
            _LOADED[self.build_dir] = (lib, len(self.program.kernels))
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def outside_reads(self) -> Dict[str, int]:
        """The staged kernels' reads at a variable or absolute K that their
        windows did not hold, counted on the device over every call so far
        (waits for the device), by kernel; each also recorded in
        ``LAST_PLAN[name]["vark"]`` as ``outside``."""
        names = [k.name for k in self.program.kernels]
        counts: Dict[str, int] = {}
        for t in self._outside.values():
            for n, c in enumerate(t.tolist()):
                if self.program.kernels[n].vark is not None:
                    counts[names[n]] = counts.get(names[n], 0) + c
        for rec in LAST_PLAN.get(self.analysis.stencil.name, {}).get("vark", []):
            rec["outside"] = counts.get(rec["kernel"], 0)
        return counts

    def device_launches(self) -> dict:
        """The library's own launch counts (one at each launch, since it was
        loaded, shared by the stencils built from one source; zeros before
        it is built): ``all`` kernels; by kernel index, ``kernels`` every
        launch of the kernel and of its variants, ``kblocked`` its K4
        launches and ``vector`` its vector row launches; ``copies`` the
        plane-sweep kernels' snapshot copies."""
        return _launch_counts(self._lib, len(self.program.kernels))

    def launches_by_form(self, counts: dict) -> Dict[str, int]:
        """The launches ``counts`` (a difference of two ``device_launches``)
        by kernel form: each kernel's own form (``"tile"``, ``"rows"``,
        ``"vark"``, ``"column"``, ``"columns"``, ``"planes"``, ``"sweep"``),
        its vector row kernel as ``"vector"``, its K4 window kernel as
        ``"kblocked"``, the snapshot copies as ``"copy"``; they add up to
        ``counts["all"]`` (only forms that launched)."""
        out: Dict[str, int] = {"copy": counts["copies"]}
        for k, n, kb, v in zip(self.program.kernels, counts["kernels"], counts["kblocked"],
                               counts["vector"]):
            for form, c in ((k.form, n - kb - v), ("kblocked", kb), ("vector", v)):
                out[form] = out.get(form, 0) + c
        return {f: c for f, c in out.items() if c}

    def _kb_init(self, device) -> None:
        """The K4 kernels' shared-memory carveout, once per device."""
        if device in self._kb_devices or not any(k.window for k in self.program.kernels):
            return
        lib = self.build()
        with torch.cuda.device(device):
            rc = lib.gt_kb_init()
        if rc != 0:
            raise RuntimeError(f"stencil '{self.analysis.stencil.name}': K4 attributes: "
                               f"{lib.gt_error_string(rc).decode()}")
        self._kb_devices.add(device)

    def apply(self, env, scalars, domain, origins, periodic=(), frame=None,
              levels=None, outputs=None) -> None:
        """Execute on ``env`` (logical views; written fields are fresh
        output buffers, see ``StencilObject._execute``); ``frame`` and
        ``levels``: the region frame and the levels run
        (``torch_backend.TorchExecutor.run``).  ``outputs`` (a dict): a call
        under K8 puts its written fields' new tensors there and leaves
        ``env`` as it was (a copy into the views would hand the backward its
        cotangents as contiguous clones); the caller takes them from there.
        A call under K8 without ``outputs`` raises."""
        kinds = {v.device.type for v in env.values()}
        if kinds == {"cpu"}:
            if self.derivative_opt == "kernels" and frame is None and levels is None and \
                    wants_derivative([*env.values(), *scalars.values()]):
                # the derivative stencils on the plain executor (their CPU form)
                self._k8(self._plain_launch, env, scalars, domain, origins, periodic, outputs)
                return
            run_plain(self.plain, env, scalars, domain, origins, periodic, frame, levels)
            return
        if kinds != {"cuda"}:
            raise ValueError(f"backend 'cuda' takes CPU or CUDA tensors, got {sorted(kinds)}")
        self.run_kernels(env, scalars, domain, origins, periodic, frame, levels, outputs)

    def _plain_launch(self, env, scalars, domain, origins, periodic) -> None:
        run_plain(self.plain, env, scalars, domain, origins, periodic)

    def run_kernels(self, env, scalars, domain, origins, periodic=(), frame=None,
                    levels=None, outputs=None) -> None:
        """Launch the kernels on ``env``; when a derivative is wanted, under
        K8: the primal from the kernels (a failed build or launch raises),
        the derivative from the derivative stencils or the plain executor.
        ``levels = (lo, hi)``: each section's bounds (gt_run's ``kbv``)
        clipped to ``[lo, hi)``; ``outputs``: see ``apply``."""
        if not wants_derivative([*env.values(), *scalars.values()]):
            self._launch(env, scalars, domain, origins, periodic, frame, levels)
            return
        if levels is not None:
            raise NotImplementedError("cuda backend: no derivative of a call on some levels "
                                      "(a phased call on DistributedFields)")
        if frame is not None:
            raise NotImplementedError("cuda backend: no derivative of a call in a region frame "
                                      "(a call on DistributedFields)")
        self._k8(self._launch, env, scalars, domain, origins, periodic, outputs)

    def _k8(self, launch, env, scalars, domain, origins, periodic, outputs) -> None:
        if outputs is None:
            raise TypeError("cuda backend: a call under K8 hands its written fields back "
                            "through apply's outputs")
        self.derivative_calls += 1
        autodiff.kernel_call(launch, self.plain, self._written, env, scalars, domain, origins,
                             periodic, outputs, kernels=self)

    def _check(self, env) -> torch.device:
        st = self.analysis.stencil
        devices = {v.device for v in env.values()}
        if len(devices) != 1:
            raise ValueError(f"fields on several devices: {sorted(map(str, devices))}")
        for name, v in env.items():
            decl = st.field_decls[name]
            want = dtypes.to_torch(decl.dtype)
            if v.dtype != want:
                raise TypeError(f"field '{name}' has dtype {v.dtype}, expected {want}")
            if tuple(v.shape[3:]) != tuple(decl.data_dims) or v.ndim != 3 + len(decl.data_dims):
                raise ValueError(
                    f"field '{name}' must be an (I, J, K, *{decl.data_dims}) view, "
                    f"got shape {tuple(v.shape)}"
                )
            if not _no_overlap(v):
                raise ValueError(f"field '{name}' is a view whose elements overlap")
        return devices.pop()

    def _depth_plan(self, columns: int, dK: int, dry: bool = False):
        """K4's block sizes on ``columns`` = dI x dJ columns of ``dK``
        levels (None: one pass), the plan
        record and gt_run's ``kbsz`` argument.  When K4 runs, the record
        holds, per column loop, KB, the ring's slots and shared bytes and
        the CTAs a SM holds (``gt_kb_occupancy``: the CUDA occupancy API
        on the current device; the library is built; ``dry``: without the
        library, by the shared-memory rule ``ctas_per_sm``).  The launches
        each loop made are added at the launch (``launches_per_loop``,
        counted by the library)."""
        key = (dK, kb_default(columns, dK), dry)
        hit = self._depth_plans.get(key)
        if hit is None:
            prog = self.program
            kbs, declined = prog.kblock_plan(columns, dK)
            plan = prog.plan_record()
            kbsz = [0] * len(prog.kernels)
            windows = [n for n, k in enumerate(prog.kernels) if k.window]
            for n, kbn in zip(windows, kbs or []):
                kbsz[n] = kbn
            kbsz = (ctypes.c_int * len(kbsz))(*kbsz)
            if kbs is None:
                plan["declined"]["kblocked"] = declined
            else:
                ws = [prog.kernels[n].window for n in windows]
                occ = [0] * len(prog.kernels)
                if dry:
                    for n, w, kbn in zip(windows, ws, kbs):
                        occ[n] = ctas_per_sm(max(16, w.smem_bytes(kbn)), KB_TILE_I * KB_TILE_J)
                else:
                    occ = (ctypes.c_int * len(prog.kernels))()
                    lib = self.build()
                    rc = lib.gt_kb_occupancy(kbsz, occ)
                    if rc != 0:
                        raise RuntimeError(f"stencil '{self.analysis.stencil.name}': occupancy "
                                           f"query failed: {lib.gt_error_string(rc).decode()}")
                plan["declined"].pop("kblocked", None)
                plan["kblocked"] = {
                    "reason": KB_DEFAULT_REASON if prog.kb_default else "k_blocked=True",
                    "passes": prog.kb_passes, "KB": kbs,
                    "slots": [w.slots for w in ws],
                    "smem_bytes": [w.smem_bytes(kb) for w, kb in zip(ws, kbs)],
                    "ctas_per_sm": [occ[n] for n in windows],
                    "promoted": list(prog.kb_promoted)}
            hit = self._depth_plans[key] = (kbs, plan, kbsz)
        return hit

    def _geometry(self, env, origins, domain, periodic, kb):
        """K6 for one call: ``(phase, pads, copied_in, record)``.  The tile
        and sweep kernels' staged inputs need no phase: each row starts at
        its own aligned-down word (``staging``: ``"row_phase"`` per field
        where J is contiguous, ``"element"`` where it is not).  ``phase``:
        the J phase of the vector row kernels' groups, the fields' common
        16-byte phase (None: the scalar row kernels run); no call is
        repaired by default.  ``pads``: the fields the repair copies, with
        ``repair=True`` (``repair.pads``: the JAX package's pass, forced) or
        where ``vector=True`` forces the vector row kernels on fields that
        share no phase; ``copied_in`` those whose read window it copies in;
        ``record``: the call's ``vector`` / ``staging`` / ``repair`` /
        ``declined`` plan entries.  Raises where a forced ``vector=True`` or
        ``repair=True`` cannot apply, as the JAX package does."""
        prog = self.program
        an = self.analysis
        decls = an.stencil.field_decls
        want = VECTOR_DEFAULT if self.vector_opt is None else self.vector_opt
        rows = sorted(n for n in prog.vector_row_fields() if n in env)
        record: dict = {"declined": {}, "staging": {
            n: "row_phase" if _j_contiguous(env[n]) else "element"
            for n in sorted(prog.staged_fields()) if n in env}}
        if not prog.vector_row_fields():
            record["declined"]["vector"] = "no row-form stage reaches a J-contiguous field"
        elif not want:
            record["declined"]["vector"] = ("vector=False" if self.vector_opt is False else
                                            "off by default (vector=True runs it)")
        names = rows if want and rows else (
            [n for n in env if vector_candidate(decls[n])] if self.repair_opt else [])
        cons = {}
        for n in names:
            ptr, rec = _field_arg(env[n], origins[n])
            cons[n] = repair.constraint(ptr, rec[:3], env[n].element_size())
        phase = repair.common_phase(list(cons.values())) \
            if cons and None not in cons.values() else None
        if phase is not None:
            if self.repair_opt:
                raise ValueError(f"stencil '{an.stencil.name}': repair=True, but the fields "
                                 "already share a 16-byte phase: no repair applies")
            return (phase if want and rows else None), {}, set(), record
        why = "the fields share no 16-byte phase with 16-byte row and level pitches"
        forced = self.repair_opt or (want and rows and self.vector_opt)
        if not forced:
            if want and rows:
                record["declined"]["vector"] = why + (" (a periodic call)" if periodic else "")
            return None, {}, set(), record
        if periodic or self.repair_opt is False:
            raise ValueError(
                f"stencil '{an.stencil.name}': {why}, and "
                f"{'a periodic call is' if periodic else 'repair=False is'} not repaired")
        phase, pads = repair.pads(env, origins, cons)
        full = {n for n in self._written if n in pads and not (an.field_info[n].access.value & 1)
                and repair.fully_written(prog.analysis, n, kb, domain[2])}
        copied_in = set(pads) - full
        record["repair"] = dict(pads)
        record["repair_in"] = sorted(copied_in)
        record["repair_bytes"] = repair.copy_bytes(an, env, origins, domain, pads, copied_in,
                                                   [n for n in self._written if n in pads])
        # the copies are (K, I, J) buffers: J-contiguous
        record["staging"] = {n: "row_phase" for n in record["staging"]}
        return (phase if want and rows else None), pads, copied_in, record

    def plan_call(self, env, scalars, domain, origins, periodic=(), dry: bool = False,
                  levels=None):
        """The plan of one call on ``env`` (logical views): the record the
        call writes to ``LAST_PLAN`` (``plan``) and what its launch needs.
        ``dry``: without the library or the device (``StencilObject.
        lowered(format="plan")`` on meta tensors; K4's CTAs a SM then come
        from ``ctas_per_sm``).  ``levels``: see ``run_kernels``."""
        prog = self.program
        dI, dJ, dK = (int(d) for d in domain)
        lo, hi = levels if levels is not None else (0, dK)
        kb = [(max(k0, lo), min(k1, hi))
              for k0, k1 in (itv.resolve(dK, scalars) for itv in prog.intervals)]
        phase, pads, copied_in, record = self._geometry(env, origins, (dI, dJ, dK), periodic, kb)
        if phase is not None or "row_phase" in record["staging"].values():
            # the elements of the 16-byte words the call's kernels move
            record["vector"] = prog.vector_width(prog.vector_fields())
        kbs, plan, kbsz = self._depth_plan(dI * dJ, dK, dry=dry)
        plan = {**plan, **record, "declined": {**plan["declined"], **record["declined"]},
                **self.derivative_plan}
        # the staged kernels' windows: each field's levels (``_vark_slots``)
        vks, windows = [], []
        for k in prog.kernels:
            if k.vark is None:
                continue
            levels = [env[n].shape[2] for n, *_ in k.vark.fields]
            slots = _vark_slots(k.vark, levels)
            vks += slots
            smem = k.vark.window_bytes(slots)
            windows.append({**k.vark.record(k.name),
                            "levels": {n: s for (n, *_), s in zip(k.vark.fields, slots)},
                            "whole": {n: s >= lv for (n, *_), s, lv in
                                      zip(k.vark.fields, slots, levels)},
                            "smem_bytes": smem,
                            "ctas_per_sm": ctas_per_sm(smem, k.vark.tile[0] * k.vark.tile[1]
                                                       * k.vark.lanes)})
        if windows:
            plan["vark"] = windows
        # a sweep kernel (1) or the kernels it replaces (0)
        swept = {n: k.sweep.ordered(kb) for n, k in enumerate(prog.kernels) if k.sweep}
        if not all(swept.values()):
            plan["forms"] = [k.form for n, k in enumerate(prog.kernels) if not k.k4_only and (
                swept[k.swept_by] is False if k.swept_by is not None else swept.get(n, True))]
            plan["declined"] = {**plan["declined"], "sweep": SWEEP_UNORDERED}
        return SimpleNamespace(plan=plan, kb=kb, phase=phase, pads=pads, copied_in=copied_in,
                               record=record, kbs=kbs, kbsz=kbsz, vks=vks, swept=swept)

    def _launch(self, env, scalars, domain, origins, periodic, frame=None, levels=None) -> None:
        prog = self.program
        st = self.analysis.stencil
        # the temporaries the caller holds (the ``held`` option), in place
        held = {n: (env[n], origins[n]) for n in env if n not in st.field_decls}
        env = {n: v for n, v in env.items() if n in st.field_decls}
        device = self._check(env)
        dI, dJ, dK = (int(d) for d in domain)
        if periodic:
            check_periodic(self.analysis, list(env), domain, periodic)
            # written fields read at offsets: the oracle's pre-run fill, in
            # the fresh output buffer (reads of them then need no wrap)
            fill = [n for n in self._written
                    if n in env and has_horizontal_reads(self.analysis, n)]
            if fill:
                periodic_fill(self.analysis, env, domain, origins, periodic, fill)
        lib = self.build()
        self._kb_init(device)
        call = self.plan_call(env, scalars, (dI, dJ, dK), origins, periodic, levels=levels)
        kb, phase, pads, copied_in, record = call.kb, call.phase, call.pads, call.copied_in, \
            call.record
        kbs, plan, kbsz, vks, swept = call.kbs, call.plan, call.kbsz, call.vks, call.swept
        LAST_PLAN[st.name] = plan
        caller, caller_origins = env, origins
        if pads:
            env, origins = repair.pad_fields(self.analysis, env, origins, (dI, dJ, dK), pads,
                                             copied_in)
        ptrs: List[int] = []
        strides: List[int] = []
        keep = []
        for name in prog.fields:
            if name in env:
                p, s = _field_arg(env[name], origins[name])
            else:
                p, s = 0, [0] * _REC
            ptrs.append(p)
            strides += s
        zeroed = zero_init_temps(prog, kb)
        # one pass: the fused column kernels keep their carried temporaries
        # in registers; those need no scratch
        on_chip = set() if kbs is not None else {
            t for k in prog.kernels if k.group for t in k.group.carries}
        views = {}
        for name in prog.scratch:
            if name in on_chip:
                ptrs.append(0)
                strides += [0] * _REC
                continue
            if name in held:
                views[name] = held[name]
                p, s = _field_arg(*views[name])
                ptrs.append(p)
                strides += s
                continue
            ext = prog.analysis.extents.alloc_extent(name)
            decl = prog.analysis.stencil.temp_decls[name]
            nj = dJ - ext.j[0] + ext.j[1]
            fj = 0
            if vector_candidate(decl):
                # J rows of whole 16-byte words, the origin on the phase
                m = 16 // np.dtype(decl.dtype).itemsize
                fj = (-(phase or 0) + ext.j[0]) % m
                nj = -(-(fj + nj) // m) * m
            shape = (dK - ext.k[0] + ext.k[1], dI - ext.i[0] + ext.i[1], nj) + \
                tuple(decl.data_dims)
            alloc = torch.zeros if name in zeroed else torch.empty
            t = alloc(shape, dtype=dtypes.to_torch(decl.dtype), device=device)
            keep.append(t)
            views[name] = (t.permute(1, 2, 0, *range(3, t.ndim)),
                           (-ext.i[0], fj - ext.j[0], -ext.k[0]))
            p, s = _field_arg(*views[name])
            ptrs.append(p)
            strides += s
        # a snapshot has its field's layout and origin; the kernels fill it
        for name in prog.snapshots:
            view, origin = views[name] if name in views else (env[name], origins[name])
            t = torch.empty_like(view)
            keep.append(t)
            p, s = _field_arg(t, origin)
            ptrs.append(p)
            strides += s
        if phase is not None:
            # the repair's copies and the scratch buffers come from the
            # allocator: their phase is checked as the caller's was
            for name in prog.vector_row_fields():
                if name in views or name in pads:
                    view, origin = views[name] if name in views else (env[name], origins[name])
                    p, s = _field_arg(view, origin)
                    c = repair.constraint(p, s[:3], view.element_size())
                    if c is None or (c[0] + phase) % c[1]:
                        raise RuntimeError(f"stencil '{st.name}': '{name}' is not on the vector "
                                           f"kernels' 16-byte phase (J {phase})")
        # per kernel: the vector row kernels' 16-byte phase + 1 (0: the
        # scalar ones); a sweep kernel (1) or the kernels it replaces (0)
        # a tile kernel whose staged rows all share one lead: its twin
        si = {}
        for b, name in enumerate(prog.fields + prog.scratch + prog.snapshots):
            si.setdefault(name, strides[_REC * b])
        vec = [int(swept[n]) if n in swept else
               int(all(si[name] % lanes == 0 for name, _, _, _, lanes in k.tile.inputs if lanes))
               if k.tile is not None else
               (phase + 1 if phase is not None and k.vector is not None else 0)
               for n, k in enumerate(prog.kernels)]
        # the tile kernels whose twin runs, the row kernels in the vector form
        plan["twins"] = [k.name for n, k in enumerate(prog.kernels) if k.tile is not None and vec[n]]
        plan["vector_rows"] = [k.name for n, k in enumerate(prog.kernels)
                               if k.tile is None and n not in swept and vec[n]]
        outside = None
        if "vark" in plan:
            outside = self._outside.get(device)
            if outside is None:
                outside = self._outside[device] = torch.zeros(
                    len(prog.kernels), dtype=torch.int64, device=device)
        kb = [k for bounds in kb for k in bounds]
        # rounded to the scalar's dtype here, so the kernel's conversion
        # from double is exact
        fsc = [float(dtypes.scalar_value(_scalar_value(scalars[n]), st.scalar_decls[n].dtype))
               for n in prog.float_scalars]
        isc = [int(_scalar_value(scalars[n])) for n in prog.int_scalars]

        counted = self.device_launches()["kblocked"] if kbs is not None else None
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.gt_run(
                (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_longlong * len(strides))(*strides),
                (ctypes.c_int * 7)(dI, dJ, dK, *(frame or (0, 0, dI, dJ))),
                (ctypes.c_int * len(kb))(*kb),
                (ctypes.c_double * max(1, len(fsc)))(*fsc),
                (ctypes.c_longlong * max(1, len(isc)))(*isc),
                int("I" in periodic), int("J" in periodic),
                ctypes.c_void_p(stream), int(kbs is not None), kbsz,
                (ctypes.c_int * len(vec))(*vec),
                (ctypes.c_int * max(1, len(vks)))(*vks),
                ctypes.c_void_p(outside.data_ptr() if outside is not None else 0),
            )
        if rc != 0:
            raise RuntimeError(
                f"CUDA launch failed in stencil '{st.name}': "
                f"{lib.gt_error_string(rc).decode()} (error {rc})"
            )
        if counted is not None:
            now = self.device_launches()["kblocked"]
            plan["kblocked"] = {**plan["kblocked"], "launches_per_loop": [
                now[n] - counted[n] for n, k in enumerate(prog.kernels) if k.window]}
        if pads:
            repair.write_back(self.analysis, caller, caller_origins, env, (dI, dJ, dK), pads,
                              [n for n in self._written if n in caller])
            self.repairs += 1
        if phase is not None or "row_phase" in record["staging"].values():
            self.vector_launches += 1
        # scratch buffers go back to the caching allocator tied to the
        # stream, so reuse by later work on the same stream is ordered
        del keep
        self.launches += 1


def _launch_counts(lib, n: int) -> dict:
    """``gt_launch_counts`` of a stencil library of ``n`` kernels (zeros
    for None), as ``CudaBackend.device_launches`` returns them."""
    out = (ctypes.c_longlong * (2 + 3 * n))()
    if lib is not None:
        lib.gt_launch_counts(out)
    return {"all": out[0], "kblocked": list(out[1:1 + n]), "kernels": list(out[1 + n:1 + 2 * n]),
            "vector": list(out[1 + 2 * n:1 + 3 * n]), "copies": out[1 + 3 * n]}


def library_launches() -> int:
    """Every kernel launch that the stencil libraries this process has
    loaded have made, each library counted once."""
    return sum(_launch_counts(lib, n)["all"] for lib, n in _LOADED.values())


def _scalar_value(v):
    if isinstance(v, torch.Tensor):
        return v.item()
    return np.asarray(v).item()
