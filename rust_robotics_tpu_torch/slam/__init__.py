from rust_robotics_tpu_torch.slam.bundle_adjustment import (  # noqa: F401
    CameraIntrinsics,
    build_bundle_adjustment,
    bundle_adjust,
    make_reprojection_residual,
)
from rust_robotics_tpu_torch.slam.ekf_slam import (  # noqa: F401
    EKFSLAMBelief,
    ekf_slam_predict,
    ekf_slam_step,
    init_ekf_slam,
)
from rust_robotics_tpu_torch.slam.fastslam import (  # noqa: F401
    FastSLAMParticles,
    fastslam1_step,
    init_fastslam,
)
from rust_robotics_tpu_torch.slam.g2o import parse_g2o, write_g2o  # noqa: F401
from rust_robotics_tpu_torch.slam.icp import ICPResult, icp_matching  # noqa: F401
from rust_robotics_tpu_torch.slam.imu import (  # noqa: F401
    Preintegrated,
    optimize_imu_trajectory,
    predict_nav_state,
    preintegrate,
)
from rust_robotics_tpu_torch.slam.pose_graph import (  # noqa: F401
    build_pose_graph_2d,
    build_pose_graph_3d,
    optimize_pose_graph_2d,
    optimize_pose_graph_3d,
    se2_edge_residual,
    se2_retract,
    se3_edge_residual,
    se3_retract,
)
from rust_robotics_tpu_torch.slam.scan_matching import (  # noqa: F401
    correlative_scan_match,
    graph_slam_from_landmarks,
    point_to_line_icp,
    robust_icp,
)
from rust_robotics_tpu_torch.slam.slam_node import (  # noqa: F401
    IcpGatingParams,
    REASONS,
    append_and_prune,
    blend_motion_delta,
    compute_icp_blend_decision,
    run_slam_node_loop,
    scan_to_points,
    subsample_stride,
)
from rust_robotics_tpu_torch.slam.vio import pose_error_se3, run_vio_pipeline  # noqa: F401
from rust_robotics_tpu_torch.slam.vio_pp import (  # noqa: F401
    run_vio_pipeline_windowed,
)
