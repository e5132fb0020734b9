from rust_robotics_tpu_torch.planning.grid import (  # noqa: F401
    GridMap,
    grid_from_obstacle_points,
    grid_from_raster,
)
from rust_robotics_tpu_torch.planning.wavefront import (  # noqa: F401
    MOTIONS_4,
    MOTIONS_8,
    extract_path,
    goal_raster,
    plan_grid,
    wavefront_costs,
)
