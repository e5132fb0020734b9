"""SPMD programs of the port's `parallel/` and `train.py`, run on gloo ranks.

`run_spmd(program, world, tmp_dir, *args)` spawns `world` CPU processes,
joins them in a gloo group through a `FileStore` under `tmp_dir` (no port,
so parallel test runs cannot collide), runs `program(*args)` on each rank
and returns the ranks' results in rank order. `run_one_process` runs a
program on a one-rank group in this process. This module imports torch
and the port only, never JAX, so a spawned rank starts in about 2 s; the
tests hold what the programs return against JAX and against the port's
one-process functions.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rust_robotics_tpu_torch.parallel import mesh as pmesh


def _entry(rank, world, store_path, out_dir, program, args):
    torch.set_num_threads(1)
    pmesh.init_process_group(rank, world, dist.FileStore(store_path, world), device_type="cpu")
    try:
        out = program(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_spmd(program, world, tmp_dir, *args):
    """program(*args) on `world` spawned gloo ranks; the results in rank
    order."""
    out_dir = os.path.join(str(tmp_dir), f"world{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    mp.spawn(_entry, args=(world, store, out_dir, program, args), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_one_process(program, *args):
    """program(*args) on a one-rank gloo group in this process."""
    pmesh.init_process_group(0, 1, device_type="cpu")
    try:
        return program(*args)
    finally:
        dist.destroy_process_group()


def _local(mesh, x):
    return pmesh.local_shard(x, mesh, "data")


def _t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# mesh, collectives, pipeline, scan odometry
# ---------------------------------------------------------------------------

def stage_fn(stage, x):
    """The homogeneous stage of the JAX dryrun's pipeline program."""
    return torch.tanh(x * (stage + 1.5)) + stage


def parallel_program(xs_np, scans_np, iterations):
    from rust_robotics_tpu_torch.parallel.pipeline import pipeline_shard_map
    from rust_robotics_tpu_torch.parallel.sharded_scan import (
        make_sharded_scan_odometry,
        scan_odometry_serial,
        shard_scans,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    mesh = pmesh.make_mesh(device_type="cpu")
    out["shape"] = tuple(mesh.shape)
    out["coords"] = (pmesh.axis_index(mesh, "data"), pmesh.axis_index(mesh, "model"))
    x = torch.arange(3, dtype=torch.float64) + 10.0 * rank
    out["psum_data"] = pmesh.psum(x, mesh, "data")
    out["psum_both"] = pmesh.psum(x, mesh, ("data", "model"))
    y = torch.tensor([-1.0, 1.0, 0.5], dtype=torch.float64) * (rank + 1)
    out["pmax_data"] = pmesh.pmax(y, mesh, "data")
    out["pmin_both"] = pmesh.pmin(y, mesh, ("data", "model"))
    out["pmin_int"] = pmesh.pmin(torch.tensor([rank, 1 - rank], dtype=torch.int32), mesh, "data")
    out["gather_data"] = pmesh.all_gather(x, mesh, "data")
    s = pmesh.axis_size(mesh, "data")
    out["ring_left"] = pmesh.ppermute(x, mesh, "data", [(i, (i - 1) % s) for i in range(s)])
    out["partial"] = pmesh.ppermute(x, mesh, "data", [(0, s - 1)])
    out["bcast"] = pmesh.broadcast(x, mesh, "data", src=s - 1)
    table = torch.arange(4 * world * 3, dtype=torch.float64).reshape(4 * world, 3)
    for dim in (0, 1):
        t = table if dim == 0 else table.T.contiguous()
        piece = pmesh.local_shard(t, mesh, "data", dim=dim)
        out[f"roundtrip{dim}"] = bool(torch.equal(pmesh.gather_shards(piece, mesh, "data", dim), t))

    pipe = pmesh.make_mesh(axis_names=("pipe",), device_type="cpu")
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        xs = _t(xs_np, dtype)
        out[f"pipe_{name}"] = pipeline_shard_map(stage_fn, xs, pipe)
        want = xs
        for k in range(world):
            want = stage_fn(k, want)
        out[f"pipe_direct_{name}"] = want

    seq = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    run = make_sharded_scan_odometry(seq, iterations=iterations)
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        scans = _t(scans_np, dtype)
        out[f"scan_{name}"] = run(shard_scans(seq, scans))
        out[f"scan_serial_{name}"] = scan_odometry_serial(scans, iterations=iterations)
    return out


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def train_program(batches, learning_rate, steps):
    """batches: {name: (controls, meas, ranges, landmarks, init_mean)} of
    numpy arrays; f64 and f32 by name. Per batch: the loss and grads at
    the initial parameters, `steps` Adam steps' losses and the parameters
    after the first and the last."""
    from rust_robotics_tpu_torch.train import (
        init_params,
        make_loss,
        make_loss_and_grad,
        make_training_step,
        shard_training_batch,
    )

    mesh = pmesh.make_mesh(device_type="cpu")
    out = {"shape": tuple(mesh.shape)}
    for name, arrays in batches.items():
        dtype = torch.float64 if name.startswith("f64") else torch.float32
        local = shard_training_batch(mesh, *(_t(a, dtype) for a in arrays))
        params = init_params(dtype, device="cpu")
        loss, grads = make_loss_and_grad(mesh)(params, *local)
        out[name] = {"loss": loss, "loss_only": make_loss(mesh)(params, *local),
                     "grads": grads.tensors()}
        init_fn, step_fn = make_training_step(mesh, learning_rate=learning_rate)
        params, state = init_fn(dtype)
        losses, firsts = [], None
        for _ in range(steps):
            params, state, loss = step_fn(params, state, *local)
            losses.append(loss)
            firsts = firsts or params.tensors()
        out[name].update(losses=torch.stack(losses), params1=firsts, params=params.tensors())
    return out


# ---------------------------------------------------------------------------
# the sharded particle filters
# ---------------------------------------------------------------------------

def filters_program(pf, fs, sharp):
    """pf: the PF banks' inputs and per-step draws; fs: FastSLAM's inputs
    and per-step draws; sharp: the resample-trigger case. Each run both
    sharded and as the one-process function in the same rank."""
    from rust_robotics_tpu_torch.filters.particle import ParticleBelief
    from rust_robotics_tpu_torch.parallel.sharded_filters import (
        fastslam_oracle_step,
        make_fastslam_sharded_step,
        make_pf_banks_step,
        pf_bank_step,
    )
    from rust_robotics_tpu_torch.slam.fastslam import FastSLAMParticles

    mesh = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        t = {k: _t(v, dtype) for k, v in pf.items() if k != "draws"}
        draws = [tuple(_t(d, dtype) for d in step) for step in pf["draws"]]
        cns, lms = t["cns"], t["landmarks"]
        step = make_pf_banks_step(mesh, pf["dt"], cns, pf["range_noise"])
        sharded = ParticleBelief(_local(mesh, t["states"]),
                                 _local(mesh, t["weights"]))
        whole = ParticleBelief(t["states"], t["weights"])
        for d in draws:
            sharded, s_est = step(sharded, _local(mesh, t["controls"]),
                                  _local(mesh, t["ranges"]), lms, draws=d)
            whole, w_est = pf_bank_step(whole, t["controls"], t["ranges"], lms, pf["dt"], cns,
                                        pf["range_noise"], draws=d)
        gen = torch.Generator().manual_seed(5)
        gen_step, _ = step(ParticleBelief(_local(mesh, t["states"]),
                                          _local(mesh, t["weights"])),
                           _local(mesh, t["controls"]),
                           _local(mesh, t["ranges"]), lms, generator=gen)
        out[f"pf_{name}"] = {
            "states": pmesh.gather_shards(sharded.states, mesh, "data"),
            "weights": pmesh.gather_shards(sharded.weights, mesh, "data"),
            "mean": pmesh.gather_shards(s_est.mean, mesh, "data"),
            "cov": pmesh.gather_shards(s_est.cov, mesh, "data"),
            "oracle": (whole.states, whole.weights, w_est.mean, w_est.cov),
            "generator_states": pmesh.gather_shards(gen_step.states, mesh, "data")}

    for case, inputs in (("fs", fs), ("sharp", sharp)):
        dtype = torch.float64
        parts = [_t(inputs[k], dtype) for k in ("poses", "weights", "lm_mean", "lm_cov")]
        seen = torch.as_tensor(np.asarray(inputs["lm_seen"]))
        whole = FastSLAMParticles(*parts, seen)
        sharded = FastSLAMParticles(*(_local(mesh, a) for a in (*parts, seen)))
        chol, r_obs = _t(inputs["chol"], dtype), _t(inputs["r_obs"], dtype)
        obs, mask, u = _t(inputs["obs"], dtype), torch.as_tensor(inputs["mask"]), _t(inputs["u"],
                                                                                      dtype)
        step = make_fastslam_sharded_step(mesh, inputs["dt"], chol, r_obs)
        for d in inputs["draws"]:
            d = tuple(_t(a, dtype) for a in d)
            sharded = step(sharded, u, obs, mask, draws=d)
            whole = fastslam_oracle_step(whole, u, obs, mask, inputs["dt"], chol, r_obs, draws=d)
        names = ("poses", "weights", "lm_mean", "lm_cov", "lm_seen")
        out[case] = {n: pmesh.gather_shards(getattr(sharded, n), mesh, "data") for n in names}
        out[case]["oracle"] = {n: getattr(whole, n) for n in names}
    return out


# ---------------------------------------------------------------------------
# the factor-sharded matrix-free PCG
# ---------------------------------------------------------------------------

def nlls_program(graphs):
    """graphs: {name: (poses, ef, et, meas, config kwargs, dtype name)}.
    Each solved by `solve_sharded` over the flat 'model' mesh; the first
    also over both axes of the ('data', 'model') mesh; and
    `optimize_pose_graph_2d_sharded` on "wrapper"."""
    from rust_robotics_tpu_torch.nlls import SolverConfig
    from rust_robotics_tpu_torch.parallel.sharded_nlls import (
        optimize_pose_graph_2d_sharded,
        solve_sharded,
    )
    from rust_robotics_tpu_torch.slam.pose_graph import build_pose_graph_2d

    flat = pmesh.make_mesh(axis_names=("model",), device_type="cpu")
    both = pmesh.make_mesh(device_type="cpu")
    out = {}
    for name, (poses, ef, et, meas, cfg, dname) in graphs.items():
        dtype = getattr(torch, dname)
        if name == "wrapper":
            values, summary = optimize_pose_graph_2d_sharded(poses, ef, et, meas, mesh=flat,
                                                             dtype=dtype)
            out[name] = (values, vars(summary))
            continue
        prob = build_pose_graph_2d(_t(poses, dtype), torch.as_tensor(ef), torch.as_tensor(et),
                                   _t(meas, dtype))
        solved, summary = solve_sharded(prob, SolverConfig(**cfg), flat, ("model",))
        out[name] = (solved.groups[0].values, vars(summary))
        if name == "circle":
            solved, summary = solve_sharded(prob, SolverConfig(**cfg), both, ("data", "model"))
            out["circle_both_axes"] = (solved.groups[0].values, vars(summary))
    return out


# ---------------------------------------------------------------------------
# the SPIKE-partitioned chain LM and its IFT
# ---------------------------------------------------------------------------

def se2_kw():
    from rust_robotics_tpu_torch.slam.pose_graph import se2_edge_residual, se2_retract

    return dict(residual_fn=se2_edge_residual, retract_fn=se2_retract, tdim=3)


def chain_args(problem, dtype=torch.float64):
    """(values0, the other arguments of `solve_chain_lm`) of a problem
    (initial, chain_meas, chain_info, loop_from, loop_to, loop_meas,
    loop_info, fixed) of numpy arrays; None infos stay None."""
    initial, cm, ci, lf, lt, lm, li, fixed = problem
    f = lambda a: None if a is None else _t(a, dtype)  # noqa: E731
    return f(initial), (f(cm), f(ci), torch.as_tensor(lf, dtype=torch.int64),
                        torch.as_tensor(lt, dtype=torch.int64), f(lm), f(li),
                        torch.as_tensor(fixed))


def ift_loss(target):
    """The IFT's loss: the squared distance of the positions to a target."""
    target = torch.as_tensor(target)

    def loss_fn(values):
        return torch.sum((values[:, :2] - target[:, :2]) ** 2)
    return loss_fn


def spike_system_solve(diag, upper, rhs, mesh):
    """`spike_solve_local` on this rank's rows of the global system,
    gathered on every rank."""
    from rust_robotics_tpu_torch.parallel.sharded_tridiag import spike_solve_local

    s, d = pmesh.axis_size(mesh, "data"), pmesh.axis_index(mesh, "data")
    m = diag.shape[0] // s
    rows = slice(d * m, (d + 1) * m)
    a_left = upper[d * m - 1].mT if d > 0 else None
    c_right = upper[(d + 1) * m - 1] if d < s - 1 else None
    x = spike_solve_local(diag[rows], upper[d * m:(d + 1) * m - 1], a_left, c_right, rhs[rows],
                          mesh, "data")
    return pmesh.gather_shards(x, mesh, "data")


def sharded_chain_program(system, problems, lm_kw, ift_cases):
    """system: (diag, upper, rhs) of numpy arrays for the SPIKE solve
    alone; problems: {name: chain problem}; each solved by the sharded LM
    with lm_kw; ift_cases: {name: (problem name, solved values, target)}
    through the sharded IFT."""
    from rust_robotics_tpu_torch.parallel.sharded_tridiag import (
        make_sharded_chain_ift,
        make_sharded_chain_solver,
    )

    mesh = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    out = {"spike": spike_system_solve(*(_t(a, torch.float64) for a in system), mesh)}
    solve = make_sharded_chain_solver(mesh, "data", **se2_kw(), **lm_kw)
    for name, problem in problems.items():
        values0, args = chain_args(problem)
        values, summary = solve(values0, *args)
        out[name] = (values, summary._asdict())
    for name, (pname, values, target) in ift_cases.items():
        ift = make_sharded_chain_ift(mesh, "data", **se2_kw(), loss_fn=ift_loss(target))
        out[name] = ift(_t(values, torch.float64), *chain_args(problems[pname])[1])
    return out


# ---------------------------------------------------------------------------
# the SPIKE fat-block ladder and the sharded general-graph solve
# ---------------------------------------------------------------------------

def sharded_banded_program(systems, grid, banded_kw):
    """systems: {name: (diag, upper, rhs)} solved by
    `make_sharded_fat_tridiag_solver`; grid: (initial, ef, et, meas, info,
    fixed) through `solve_general_graph_sharded` with banded_kw."""
    from rust_robotics_tpu_torch.parallel.sharded_banded import (
        make_sharded_fat_tridiag_solver,
        solve_general_graph_sharded,
    )

    mesh = pmesh.make_mesh(axis_names=("data",), device_type="cpu")
    solve = make_sharded_fat_tridiag_solver(mesh, "data")
    out = {name: solve(*(_t(a, torch.float64) for a in system))
           for name, system in systems.items()}
    initial, ef, et, meas, info, fixed = grid
    values, summary, _ = solve_general_graph_sharded(_t(initial, torch.float64), ef, et, meas,
                                                     info, fixed, mesh, "data", **se2_kw(),
                                                     **banded_kw)
    out["grid"] = (values, summary._asdict())
    return out
