from rust_robotics_tpu_torch.experiments.ukf_ckf_accuracy import (  # noqa: F401
    AccuracyObservation,
    SCENARIO_FAMILIES,
    run_ukf_ckf_accuracy,
)
from rust_robotics_tpu_torch.experiments.path_tracking import (  # noqa: F401
    run_path_tracking_accuracy,
)
from rust_robotics_tpu_torch.experiments.drone_quality import (  # noqa: F401
    run_drone_trajectory_quality,
)
from rust_robotics_tpu_torch.experiments.point_cloud_sampling import (  # noqa: F401
    AGGREGATION_VARIANTS,
    CloudCase,
    PointSamplingObservation,
    PROCESS_PROBLEMS,
    run_point_cloud_sampling_quality,
)
