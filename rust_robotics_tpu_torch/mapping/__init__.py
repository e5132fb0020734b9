from rust_robotics_tpu_torch.mapping.occupancy import (  # noqa: F401
    OccupancyGridConfig,
    lidar_to_grid,
    raycast_update,
)
from rust_robotics_tpu_torch.mapping.distance import compute_sdf, compute_udf  # noqa: F401
from rust_robotics_tpu_torch.mapping.gaussian_map import gaussian_grid_map  # noqa: F401
from rust_robotics_tpu_torch.mapping.ndt import ndt_grid  # noqa: F401
from rust_robotics_tpu_torch.mapping.gp import gp_regression  # noqa: F401
from rust_robotics_tpu_torch.mapping.cluster import (  # noqa: F401
    dbscan,
    estimate_normals,
    farthest_point_sample,
    fit_circle,
    fit_rectangle,
    kmeans,
    poisson_disk_sample,
    voxel_sample_mask,
)
from rust_robotics_tpu_torch.mapping.ndt import ndt_score  # noqa: F401
from rust_robotics_tpu_torch.mapping.occupancy import occupancy_probability  # noqa: F401
