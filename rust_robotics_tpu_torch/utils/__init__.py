from rust_robotics_tpu_torch.utils.bench_gate import compare_csv  # noqa: F401
from rust_robotics_tpu_torch.utils.experiments import (  # noqa: F401
    ExperimentVariantReport,
    VariantDescriptor,
    annotate_against_reference,
)
