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
from rust_robotics_tpu_torch.ops.wavefront_sweep import (  # noqa: F401
    incoming_bits,
    wavefront_costs_fused,
    wavefront_relax,
    wavefront_relax_plain,
    wavefront_sweeps,
    wavefront_sweeps_plain,
)
from rust_robotics_tpu_torch.ops.resample import (  # noqa: F401
    resample_reference,
    systematic_resample_gather,
    systematic_resample_gather_plain,
)
from rust_robotics_tpu_torch.ops.cholesky import (  # noqa: F401
    cholesky_blocked,
    cholesky_blocked_large,
    cholesky_blocked_plain,
    cholesky_solve_blocked,
)
