"""N-rank weak-scaling report (SURVEY §7.2 M6).

The port of rust_robotics_tpu/demos/scaling_report.py. The reference has
nothing to compare here (it is single-threaded). This module is the
measurement harness: it runs the flagship sharded training step
(train.py: DP batch sharding + TP landmark sharding with explicit
all-reduces) at weak scale — per-rank workload held constant while the
mesh grows — and reports steps/s, items/s, and efficiency vs the
smallest run; `run_chain_weak_scaling` does the same for the
SPIKE-partitioned chain LM (parallel/sharded_tridiag.py).

A mesh of n ranks is n processes of one `torch.distributed` group, one
rank per card over NCCL (`device_type="cuda"`, the default), or the
CPU "fake cluster" over gloo (`device_type="cpu"`, one OS process per
rank joined as parallel/fake_cluster.py's workers join). A one-rank mesh
runs in the calling process, which must not have a default group yet;
larger meshes start their ranks as `python -m
rust_robotics_tpu_torch.demos.scaling_report --worker DIR RANK`. A size
larger than the ranks available (the cards, or the CPU's cores) is
skipped, as JAX skips sizes beyond its devices. On the fake
cluster the numbers validate the harness, not hardware.

Usage: python -m rust_robotics_tpu_torch.demos.scaling_report [--sizes 1,2,4,8]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["run_scaling_report", "run_chain_weak_scaling"]


def _train_rows(n_devices, device_type, per_device_batch, steps, reps, dtype, draws):
    """This rank's run of the training step on an n-rank mesh; the row."""
    from rust_robotics_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from rust_robotics_tpu_torch.train import (
        make_training_step, shard_training_batch, synthesize_batch)

    mesh = make_mesh(n_devices, device_type=device_type)
    n_data, n_model = mesh.shape
    batch = per_device_batch * n_data
    num_landmarks = max(16, 8 * n_model)
    dev = mesh_device(mesh)
    if draws is None:
        # drawn on the CPU, so the batch is the same on every device
        draws = synthesize_batch(0, batch=batch, steps=steps, num_landmarks=num_landmarks,
                                 dtype=torch.float64, device="cpu")
    global_batch = [torch.as_tensor(np.array(d), device=dev).to(dtype) for d in draws]
    local = shard_training_batch(mesh, *global_batch)
    init_fn, step_fn = make_training_step(mesh)
    params, opt = init_fn(dtype)
    params, opt, loss = step_fn(params, opt, *local)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        params, opt, loss = step_fn(params, opt, *local)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {
        "devices": n_devices,
        "mesh": f"{n_data}x{n_model}",
        "global_batch": batch,
        "step_s": dt,
        "items_per_s": batch * steps / dt,
        "items_per_s_per_device": batch * steps / dt / n_devices,
        "loss": float(loss),
    }


def _chain_rows(n_devices, device_type, poses_per_device, max_iterations, reps):
    """This rank's run of the SPIKE chain LM (f32) on an n-rank mesh; the row."""
    from rust_robotics_tpu_torch.demos.pose_graph_bench import rmse, synthesize_chain
    from rust_robotics_tpu_torch.nlls.tridiag import classify_chain_edges
    from rust_robotics_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from rust_robotics_tpu_torch.parallel.sharded_tridiag import make_sharded_chain_solver
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    mesh = make_mesh(n_devices, axis_names=("data",), device_type=device_type)
    dev = mesh_device(mesh)
    n_poses = poses_per_device * n_devices
    truth, initial, ef, et, meas, info = synthesize_chain(n_poses)
    c_meas, c_info, l_ef, l_et, l_meas, l_info = classify_chain_edges(n_poses, ef, et, meas, info)
    fixed = torch.zeros((n_poses,), dtype=torch.bool, device=dev)
    fixed[0] = True
    solver = make_sharded_chain_solver(
        mesh, "data", residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3,
        max_iterations=max_iterations, gradient_tolerance=1e-8, step_tolerance=1e-8,
        cost_tolerance=1e-16)
    f32 = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(torch.float32)  # noqa: E731
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(torch.int64)  # noqa: E731
    args = (f32(initial), f32(c_meas), f32(c_info), i64(l_ef), i64(l_et), f32(l_meas),
            f32(l_info), fixed)
    out, _ = solver(*args)  # settle
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, _ = solver(*args)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {
        "devices": n_devices,
        "poses": n_poses,
        "solve_s": dt,
        "poses_per_s": n_poses / dt,
        "poses_per_s_per_device": n_poses / dt / n_devices,
        "rmse": rmse(out.cpu().numpy(), truth),
    }


_KINDS = {"train": _train_rows, "chain": _chain_rows}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _available(device_type):
    """The ranks a mesh may have: the cards (raising without NCCL on a card,
    `parallel/mesh.py`'s rule), or a process a core on the CPU."""
    from rust_robotics_tpu_torch.parallel.mesh import _check_device_type

    _check_device_type(device_type)
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _run_mesh(kind, n, device_type, kwargs, draws=None):
    """The row of one n-rank mesh: in this process for one rank, else from
    rank 0 of n worker processes."""
    from rust_robotics_tpu_torch.parallel.mesh import init_process_group

    if n == 1:
        if dist.is_initialized():
            raise RuntimeError("a one-rank mesh runs in this process, which already has a "
                               "default process group")
        init_process_group(0, 1, device_type=device_type)
        try:
            return _KINDS[kind](1, device_type, **kwargs,
                                **({} if kind == "chain" else {"draws": draws}))
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.json"), "w") as fh:
            json.dump({"kind": kind, "n": n, "device_type": device_type,
                       "kwargs": {k: (str(v).split(".")[-1] if isinstance(v, torch.dtype)
                                      else v) for k, v in kwargs.items()}}, fh)
        if draws is not None:
            np.savez(os.path.join(tmp, "draws.npz"), *[np.asarray(d) for d in draws])
        root = str(Path(__file__).resolve().parents[2])
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
        cmd = [sys.executable, "-m", "rust_robotics_tpu_torch.demos.scaling_report", "--worker",
               tmp]
        procs = [subprocess.Popen([*cmd, str(r)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, o[-2000:]) for r, (p, o) in enumerate(zip(procs, outs))
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"scaling worker(s) failed: {bad}")
        with open(os.path.join(tmp, "row.json")) as fh:
            return json.load(fh)


def _worker(tmp, rank):
    """One rank of an n-rank mesh: join the group through a file store in
    `tmp`, run the kind named in `tmp/args.json`, rank 0 writes the row."""
    from rust_robotics_tpu_torch.parallel import fake_cluster

    with open(os.path.join(tmp, "args.json")) as fh:
        spec = json.load(fh)
    kwargs = dict(spec["kwargs"])
    if "dtype" in kwargs:
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    if spec["kind"] == "train":
        path = os.path.join(tmp, "draws.npz")
        kwargs["draws"] = None
        if os.path.exists(path):
            with np.load(path) as z:
                kwargs["draws"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    fake_cluster._join(f"file://{tmp}/store", spec["n"], rank, spec["device_type"])
    try:
        row = _KINDS[spec["kind"]](spec["n"], spec["device_type"], **kwargs)
        if rank == 0:
            with open(os.path.join(tmp, "row.json"), "w") as fh:
                json.dump(row, fh)
    finally:
        dist.destroy_process_group()


def _efficiency(rows, per_device):
    if rows:
        base = rows[0][per_device]
        for r in rows:
            r["efficiency"] = r[per_device] / base
    return rows


def run_scaling_report(sizes: Sequence[int] = (1, 2, 4, 8), per_device_batch: int = 8,
                       steps: int = 16, reps: int = 5, device_type: str = "cuda",
                       dtype=torch.float32, draws=None):
    """Weak-scaling sweep of the training step; returns rows (JAX's keys)
    with `efficiency` = per-rank throughput normalized to the smallest run.
    `draws`: {size: (controls, measurements, ranges, landmarks, init_mean)}
    global batches (JAX: `synthesize_batch(PRNGKey(0), ...)` at that size);
    else each batch is drawn from a CPU generator seeded 0."""
    avail = _available(device_type)
    kw = dict(per_device_batch=per_device_batch, steps=steps, reps=reps, dtype=dtype)
    rows = [_run_mesh("train", n, device_type, kw, (draws or {}).get(n))
            for n in sizes if n <= avail]
    return _efficiency(rows, "items_per_s_per_device")


def run_chain_weak_scaling(sizes: Sequence[int] = (1, 2, 4, 8), poses_per_device: int = 2048,
                           max_iterations: int = 8, reps: int = 3, device_type: str = "cuda"):
    """Weak-scaling rows for the FLAGSHIP workload: the SPIKE-partitioned
    chain LM (parallel/sharded_tridiag) at `poses_per_device` poses per
    rank, f32. Per-rank work is constant; the interface system grows only
    as 2·D·t. Reports solve seconds, poses/s, and efficiency vs the
    smallest mesh."""
    avail = _available(device_type)
    kw = dict(poses_per_device=poses_per_device, max_iterations=max_iterations, reps=reps)
    rows = [_run_mesh("chain", n, device_type, kw) for n in sizes if n <= avail]
    return _efficiency(rows, "poses_per_s_per_device")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chain", action="store_true",
                    help="also run the flagship chain weak-scaling sweep")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = run_scaling_report(sizes, args.per_device_batch, device_type=args.device_type)
    print("devices,mesh,global_batch,step_s,items_per_s,efficiency")
    for r in rows:
        print(f"{r['devices']},{r['mesh']},{r['global_batch']},"
              f"{r['step_s']:.6f},{r['items_per_s']:.1f},"
              f"{r['efficiency']:.3f}")
    if args.chain:
        rows = run_chain_weak_scaling(sizes, device_type=args.device_type)
        print("devices,poses,solve_s,poses_per_s,rmse,efficiency")
        for r in rows:
            print(f"{r['devices']},{r['poses']},{r['solve_s']:.4f},"
                  f"{r['poses_per_s']:.1f},{r['rmse']:.2e},"
                  f"{r['efficiency']:.3f}")
