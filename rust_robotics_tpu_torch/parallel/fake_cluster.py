"""Multi-process "fake cluster" workers (SURVEY §4/§7.2 M6).

The port of rust_robotics_tpu/parallel/fake_cluster.py. Each worker is one
process, one rank of a gloo group on the CPU: the same code path that
spans hosts on NCCL. tests/test_torch_fake_cluster.py launches N of them
and checks that the collectives complete, that every process prints the
same numbers, and that they match the one-process run.

Run directly:
    python -m rust_robotics_tpu_torch.parallel.fake_cluster \\
        <init method> <num_processes> <process_id> [pipeline|spike]

The init method is a `torch.distributed` one: `file://<path>` (a file
every process can reach, no port) or `tcp://<host>:<port>`.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from rust_robotics_tpu_torch.parallel import mesh as pmesh


def _join(init_method: str, num_processes: int, process_id: int):
    """Join the gloo group of `num_processes` ranks as rank `process_id`."""
    store, _, _ = next(dist.rendezvous(init_method, process_id, num_processes))
    pmesh.init_process_group(process_id, num_processes, store, device_type="cpu")


def run_worker(init_method: str, num_processes: int, process_id: int, batch_per_proc: int = 4,
               steps: int = 8):
    """The DP+TP training step (train.py) on a (num_processes, 1) mesh, two
    Adam steps; prints the replicated loss."""
    from rust_robotics_tpu_torch.train import (
        make_training_step,
        shard_training_batch,
        synthesize_batch,
    )

    _join(init_method, num_processes, process_id)
    try:
        mesh = pmesh.make_mesh(data_axis=num_processes, device_type="cpu")
        batch = synthesize_batch(0, batch=batch_per_proc * num_processes, steps=steps,
                                 num_landmarks=16, device="cpu")
        local = shard_training_batch(mesh, *batch)
        init_fn, step_fn = make_training_step(mesh)
        params, opt = init_fn()
        loss = None
        for _ in range(2):
            params, opt, loss = step_fn(params, opt, *local)
        # the loss is replicated: every process reads the same global value
        print(f"FAKECLUSTER proc={process_id} loss={float(loss):.10f}", flush=True)
    finally:
        dist.destroy_process_group()


def run_pipeline_worker(init_method: str, num_processes: int, process_id: int):
    """One stage of `pipeline_shard_map` per process: the microbatches
    cross the process boundary by ring shifts over gloo."""
    from rust_robotics_tpu_torch.parallel.pipeline import pipeline_shard_map

    _join(init_method, num_processes, process_id)
    try:
        mesh = pmesh.make_mesh(axis_names=("pipe",), device_type="cpu")
        xs = torch.arange(10.0 * 3).reshape(10, 3) / 7.0

        def stage_fn(stage, x):
            return torch.tanh(x * (stage + 1.5)) + stage

        ys = pipeline_shard_map(stage_fn, xs, mesh)
        want = xs
        for s in range(num_processes):
            want = stage_fn(s, want)
        err = float(torch.max(torch.abs(ys - want)))
        print(f"FAKEPIPE proc={process_id} err={err:.3e} sum={float(torch.sum(ys)):.10f}",
              flush=True)
    finally:
        dist.destroy_process_group()


def run_spike_worker(init_method: str, num_processes: int, process_id: int,
                     n_poses: int = 512):
    """The SPIKE-partitioned chain LM (sharded_tridiag.py), f32, one mesh
    slot per process: the halo shifts, the interface all-gathers and the
    Woodbury psums cross the process boundary over gloo."""
    import numpy as np

    from rust_robotics_tpu_torch.demos.pose_graph_bench import rmse, synthesize_chain
    from rust_robotics_tpu_torch.nlls.tridiag import classify_chain_edges
    from rust_robotics_tpu_torch.parallel.sharded_tridiag import make_sharded_chain_solver
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    _join(init_method, num_processes, process_id)
    try:
        mesh = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
        truth, initial, ef, et, meas, info = synthesize_chain(n_poses)
        cm, ci, lf, lt, lm, li = classify_chain_edges(n_poses, ef, et, meas, info)
        fixed = torch.zeros(n_poses, dtype=torch.bool)
        fixed[0] = True
        solver = make_sharded_chain_solver(
            mesh, "data", residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3,
            max_iterations=12, gradient_tolerance=1e-8, step_tolerance=1e-8,
            cost_tolerance=1e-16)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
        out, summ = solver(f32(initial), f32(cm), f32(ci), torch.as_tensor(lf, dtype=torch.int64),
                           torch.as_tensor(lt, dtype=torch.int64), f32(lm), f32(li), fixed)
        # the solution comes back gathered on every process
        err = rmse(out.numpy(), truth)
        print(f"FAKESPIKE proc={process_id} rmse={err:.8e} cost={float(summ.final_cost):.10f} "
              f"iters={int(summ.iterations)}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker = {"pipeline": run_pipeline_worker, "spike": run_spike_worker}.get(
        sys.argv[4] if len(sys.argv) > 4 else None, run_worker)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
