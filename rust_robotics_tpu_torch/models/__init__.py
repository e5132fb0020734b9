from rust_robotics_tpu_torch.models.motion import (  # noqa: F401
    unicycle_jacobian,
    unicycle_jacobian_autodiff,
    unicycle_propagate,
)
from rust_robotics_tpu_torch.models.observation import (  # noqa: F401
    position_jacobian,
    position_observe,
    range_bearing_observe,
    range_observe,
)
