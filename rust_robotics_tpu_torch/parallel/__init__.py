"""Parallel execution over devices (the port of rust_robotics_tpu/parallel):
the GPipe schedule of heterogeneous stages (`pipeline.py`), and the SPMD
programs on `torch.distributed`: the mesh and its collectives (`mesh.py`),
the sharded particle filters (`sharded_filters.py`), the factor-sharded
matrix-free PCG (`sharded_nlls.py`), ring-halo scan odometry
(`sharded_scan.py`), the systolic pipeline (`pipeline_shard_map`), the
SPIKE-partitioned chain LM and its IFT (`sharded_tridiag.py`), the SPIKE
fat-block ladder for general graphs (`sharded_banded.py`) and their
accounting (`accounting.py`); `fake_cluster.py` runs them as one process
per rank."""

from rust_robotics_tpu_torch.parallel.mesh import (  # noqa: F401
    gather_shards,
    local_shard,
    make_mesh,
)
from rust_robotics_tpu_torch.parallel.pipeline import (  # noqa: F401
    Stage,
    pipeline_schedule,
    pipeline_shard_map,
    run_pipelined,
    run_sequential,
)
