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
from rust_robotics_tpu_torch.planning.curves import (  # noqa: F401
    CubicSpline1D,
    QuinticPolynomial,
    Spline2D,
    bezier_path,
    bspline_course,
    calc_spline_course,
    catmull_rom_course,
    dubins_shortest_path,
)
from rust_robotics_tpu_torch.planning.frenet import (  # noqa: F401
    FrenetConfig,
    frenet_optimal_plan,
)
from rust_robotics_tpu_torch.planning.hybrid_astar import (  # noqa: F401
    extract_hybrid_path,
    hybrid_astar_costs,
)
from rust_robotics_tpu_torch.planning.rrt import (  # noqa: F401
    RRTConfig,
    extract_rrt_path,
    rrt_plan,
)
from rust_robotics_tpu_torch.planning.rrt_kinematic import (  # noqa: F401
    KinematicRRTConfig,
    LQRRRTConfig,
    closed_loop_rrt_star_plan,
    extract_pose_path,
    lqr_rrt_star_plan,
    rrt_dubins_plan,
    rrt_star_dubins_plan,
    rrt_star_reeds_shepp_plan,
)
from rust_robotics_tpu_torch.planning.rrt_variants import (  # noqa: F401
    GraphPlannerConfig,
    bidirectional_rrt_plan,
    bit_star_plan,
    extract_graph_path,
    fmt_star_plan,
    graph_shortest_path,
    informed_rrt_star_plan,
    rrg_plan,
    rrt_connect_plan,
    rrt_sobol_plan,
    sobol_sequence_2d,
)
from rust_robotics_tpu_torch.planning.rrt_variants import (  # noqa: F401
    shortcut_path as shortcut_waypoint_path,
)
