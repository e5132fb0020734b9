from rust_robotics_tpu_torch.slam.bundle_adjustment import (  # noqa: F401
    CameraIntrinsics,
    build_bundle_adjustment,
    bundle_adjust,
    make_reprojection_residual,
)
from rust_robotics_tpu_torch.slam.icp import ICPResult, icp_matching  # noqa: F401
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
