from rust_robotics_tpu_torch.core import angles, types  # noqa: F401
from rust_robotics_tpu_torch.core.angles import angle_diff, normalize_angle  # noqa: F401
from rust_robotics_tpu_torch.core.types import (  # noqa: F401
    GaussianBelief,
    GridSpec2D,
    Path2D,
    Pose2D,
    State2D,
)
