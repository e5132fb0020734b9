from rust_robotics_tpu_torch.ops.smallmat import (  # noqa: F401
    cholesky_small,
    det_small,
    inv_spd_small,
    solve_spd_small,
)
from rust_robotics_tpu_torch.ops.ekf_scan import (  # noqa: F401
    ekf_scan_lanes,
    ekf_scan_plain,
    ekf_scan_reference,
)
