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
from rust_robotics_tpu_torch.planning.dwa import DWAConfig, dwa_step  # noqa: F401
from rust_robotics_tpu_torch.planning.grid3d import (  # noqa: F401
    extract_path_3d,
    plan_grid_3d,
    wavefront_costs_3d,
)
from rust_robotics_tpu_torch.planning.incremental import (  # noqa: F401
    ara_star_plan,
    beam_search_costs,
    dstar_lite_replan,
    dstar_replan,
    fringe_search_costs,
    ida_star_costs,
    lpa_star_replan,
    octile_heuristic,
    relax_with_stats,
    repair_costs,
)
from rust_robotics_tpu_torch.planning.smoothing import (  # noqa: F401
    relax_path,
    shortcut_path,
)
from rust_robotics_tpu_torch.planning.jps import (  # noqa: F401
    jps_costs,
    jps_plan,
    jump_distances,
    jump_point_mask,
)
from rust_robotics_tpu_torch.planning.fields import (  # noqa: F401
    boustrophedon_sweep,
    flow_field,
    potential_field,
)
from rust_robotics_tpu_torch.planning.conformal import (  # noqa: F401
    calibration_errors_from_trajectories,
    confidence_field,
    conformal_sipp_plan,
    empirical_quantile,
)
from rust_robotics_tpu_torch.planning.any_angle import (  # noqa: F401
    VisibilityPlanner,
    corner_vertices,
    theta_wavefront_costs,
)
from rust_robotics_tpu_torch.planning.a_star_variants import (  # noqa: F401
    AStarVariantConfig,
    AStarVariantPlanner,
)
