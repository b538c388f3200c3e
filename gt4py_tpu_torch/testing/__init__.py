"""Testing support for the port.

- ``surface``: the stencils that hold the generated kernels to the plain
  executor (``load_stencil_defs``, ``SURFACE``, ``run_pair``,
  ``plain_form``, ``plain_kblocked``), re-exported here;
- ``program_gen``, ``next_fuzz``, ``gather_fuzz``: the differential
  fuzzers of the JAX package's ``gt4py_tpu.testing``, on the port's
  backends and a device;
- ``suites``: the hypothesis ``StencilTestSuite`` (its API re-exported
  here; ``pytest`` and ``hypothesis`` are imported only when a suite
  runs).
"""

from .surface import (  # noqa: F401
    F64,
    I64,
    ROOT,
    STENCIL_DEFS,
    SURFACE,
    at_k_field,
    at_k_in_scan,
    at_k_literal,
    at_k_scalar,
    bfloat16_hdiff_sweep,
    data_dims_dynamic_write,
    data_dims_writes,
    float16_hdiff_sweep,
    load_stencil_defs,
    plain_form,
    plain_kblocked,
    registry_case,
    run_pair,
    variable_k_after_write,
    variable_k_in_scan,
)
from .suites import (  # noqa: F401
    StencilTestSuite,
    field,
    global_name,
    none,
    parameter,
)
