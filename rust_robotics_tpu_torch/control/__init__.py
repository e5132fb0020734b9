from rust_robotics_tpu_torch.control.admm import (  # noqa: F401
    ADMMConfig,
    solve_consensus,
    solve_formation_consensus,
)
from rust_robotics_tpu_torch.control.aerial import (  # noqa: F401
    minimum_snap_coeffs,
    quintic_3d_segments,
    simulate_quadrotor,
)
from rust_robotics_tpu_torch.control.arena import run_controller_arena  # noqa: F401
from rust_robotics_tpu_torch.control.arm import (  # noqa: F401
    arm_collides_3d,
    forward_kinematics,
    forward_kinematics_3d,
    inverse_kinematics_3d,
    jacobian_3d,
    resolved_rate_ik,
    rrt_star_arm_plan,
    two_joint_ik,
)
from rust_robotics_tpu_torch.control.cbf import (  # noqa: F401
    CBFConfig,
    cbf_filter_single_integrator,
    solve_qp_dual,
)
from rust_robotics_tpu_torch.control.mission import (  # noqa: F401
    Action,
    Condition,
    Selector,
    Sequence,
    StateMachine,
    Status,
    make_waypoint_mission,
)
from rust_robotics_tpu_torch.control.mpc import MPCConfig, mpc_control  # noqa: F401
from rust_robotics_tpu_torch.control.mppi import (  # noqa: F401
    MPPIConfig,
    mppi_plan,
    shift_nominal,
)
from rust_robotics_tpu_torch.control.nonlinear import (  # noqa: F401
    backstepping_control,
    feedback_linearization_control,
    sliding_mode_control,
)
from rust_robotics_tpu_torch.control.trackers import (  # noqa: F401
    LQRSteerConfig,
    MoveToPoseConfig,
    PIDConfig,
    PurePursuitConfig,
    RearWheelFeedbackConfig,
    StanleyConfig,
    bicycle_kinematics,
    lqr_steer_control,
    move_to_pose_control,
    pid_reset,
    pid_step,
    pure_pursuit_control,
    rear_wheel_feedback_control,
    stanley_control,
)
from rust_robotics_tpu_torch.control.trajopt import (  # noqa: F401
    ddp_solve,
    ilqr_solve,
    lqr_regulator,
)
from rust_robotics_tpu_torch.control.mppi_value import (  # noqa: F401
    ReplayBuffer,
    TerminalValueGrid,
    ValueUpdateConfig,
    WaypointTrack,
    discounted_cost_to_go,
    grid_from_goal_distance,
    grid_value_at,
    make_track,
    make_value_terminal_cost,
    replay_push,
    replay_update_grid,
    track_terminal_value_grid,
    update_grid_from_rollout,
)
