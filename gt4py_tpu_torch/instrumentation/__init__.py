from .metrics import (  # noqa: F401
    MetricLevel,
    Metric,
    MetricsCollection,
    collection,
    collect_sample,
    dump_metrics,
    profile_range,
)
from .hooks import (  # noqa: F401
    ContextHook,
    EventHook,
    compile_variant_hook,
    compiled_program_call_context,
    program_call_context,
    stencil_build_hook,
    stencil_call_context,
)
