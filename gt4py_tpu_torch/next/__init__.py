"""gt4py_tpu_torch.next: the declarative field-view DSL over torch tensors.

The counterpart of ``gt4py_tpu.next`` (reference: src/gt4py/next/common.py,
ffront/decorator.py, embedded/nd_array_field.py): dimensions are
first-class, fields carry their domain, binary operations intersect
domains automatically, offsets shift domains or gather through
connectivities, and ``@scan_operator`` provides column scans.

Execution: embedded, eagerly on the tensors' device (``backends.torch_eager``,
or with no backend), on the numpy oracle (``backends.numpy_oracle``), or
lowered onto the generated CUDA stencil kernels (``with_backend("cuda")``,
``cuda_bridge``).  Gathers through numpy neighbor tables plan as affine
windows (``affine_remap``) or sort-routed static permutations
(``sort_route``, on the K9 kernel ``benes``).  Not ported yet:
``distributed`` and the suites.
"""

from .common import (  # noqa: F401
    CartesianConnectivity,
    Dimension,
    DimensionKind,
    Domain,
    Field,
    FieldOffset,
    Connectivity,
    GridType,
    UnitRange,
    domain,
    is_scalar_type,
    unit_range,
)
from .constructors import as_connectivity, as_field, empty, full, ones, zeros  # noqa: F401
from .ffront import field_operator, program, scan_operator  # noqa: F401
from .compiled_program import wait_for_compilation  # noqa: F401
from . import backends  # noqa: F401  (numpy_oracle / torch / cuda)
from .builtins import (  # noqa: F401
    abs,  # noqa: A004
    arccos,
    arccosh,
    arcsin,
    arcsinh,
    arctan,
    arctanh,
    as_offset,
    astype,
    broadcast,
    cbrt,
    ceil,
    concat_where,
    cos,
    cosh,
    exp,
    gamma,
    floor,
    fmod,
    isfinite,
    isinf,
    isnan,
    log,
    log2,
    log10,
    maximum,
    max_over,
    minimum,
    min_over,
    neg,
    neighbor_sum,
    power,
    premap,
    sin,
    sinh,
    sqrt,
    tan,
    tanh,
    trunc,
    where,
)
from .type_system import (  # noqa: F401
    Dims,
    IndexType,
    bfloat16,
    bool_,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
    uint16,
    uint32,
    uint64,
)
from . import type_system  # noqa: F401
