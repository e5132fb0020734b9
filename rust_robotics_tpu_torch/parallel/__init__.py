"""Parallel execution over devices (the port of rust_robotics_tpu/parallel):
`pipeline.py`, the GPipe schedule of heterogeneous stages."""

from rust_robotics_tpu_torch.parallel.pipeline import (  # noqa: F401
    Stage,
    pipeline_schedule,
    run_pipelined,
    run_sequential,
)
