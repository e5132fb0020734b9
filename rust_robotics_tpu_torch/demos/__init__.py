from rust_robotics_tpu_torch.demos.ekf_localization import (  # noqa: F401
    default_ekf_noise,
    deterministic_noise,
    run_ekf_localization_demo,
)
