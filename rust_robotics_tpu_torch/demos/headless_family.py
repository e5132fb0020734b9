"""The full headless demo family — CI-runnable deterministic closed-loop
sims mirroring the reference's 26 `headless_*` examples
(crates/rust_robotics/Cargo.toml:60-470; SURVEY.md §2.11).

The port of rust_robotics_tpu/demos/headless_family.py. Three demos live
in `demos/headless.py` (navigation loop, mission recovery, EuRoC VIO);
this module adds the remaining 23 and a registry `HEADLESS` mapping
reference example name -> callable returning a metrics dict. Every demo
follows the gallery convention: fixed seeds and sinusoid pseudo-noise so
outputs are deterministic (render_gif_ekf_localization.rs:21-24), and
each returns the same summary metrics its reference counterpart prints.

Every demo runs on `device` (default cuda) in `dtype`. Where the JAX demo
draws from a PRNG key, the port takes `draws=` (the standard normals or
uniforms that key gives, laid out as each docstring says) or a
`torch.Generator`; without either it seeds a generator on the device
with the number of JAX's key. The closed loops read the device as often
as JAX's do: `_mppi_loop` reads the state, the stage cost and the ESS
once a step, the localizer a float a filter a step.

Per-demo reference citations sit on the docstrings below.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._graphs import Graphed
from rust_robotics_tpu_torch._numeric import norm2
from rust_robotics_tpu_torch.control._small import rsum

__all__ = ["HEADLESS", "run_headless"]


def _np(x):
    """A tensor (any device) or host data as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _generator(generator, seed, dev):
    """`generator`, else a generator on `dev` seeded with JAX's key number."""
    if generator is not None:
        return generator
    return torch.Generator(device=dev).manual_seed(seed)


def _normals(draws, generator, seed, shape, f, dev):
    """`draws` as a `f` tensor on `dev`, else standard normals of `shape`
    from `_generator(generator, seed, dev)`."""
    if draws is not None:
        return _float_on(draws, dev, f)
    return torch.randn(shape, generator=_generator(generator, seed, dev), dtype=f, device=dev)


# ---------------------------------------------------------------------------
# Localization / estimation


def headless_localizers(steps: int = 150, device=None, dtype=torch.float32, draws=None,
                        generator=None):
    """Shared-sim localizer comparison (headless_localizers.rs): EKF, UKF,
    CKF and a range-landmark particle filter track the same unicycle truth;
    reports per-filter position RMSE.

    draws: (init [512, 4] normals of the particle cloud, predict [steps,
    512, 2] normals of each step's control noise, resample [steps, 1]
    uniforms of each step's systematic resampling), as JAX's keys 0 and 1
    give them; else drawn from `generator` (seeded 0 without one)."""
    from rust_robotics_tpu_torch.core.types import GaussianBelief
    from rust_robotics_tpu_torch.filters.kalman import ckf_step, ekf_step, ukf_step
    from rust_robotics_tpu_torch.filters.particle import (
        ParticleBelief, inverse_cdf, pf_estimate, pf_predict, pf_update_ranges,
        resample_if_needed, systematic_positions)
    from rust_robotics_tpu_torch.models.motion import unicycle_propagate

    dev = resolve_device(device)
    f = dtype
    n_p = 512
    dt = 0.1
    q = torch.diag(_float_on([0.1, 0.1, 0.017, 0.3], dev, f)) ** 2
    r = torch.diag(_float_on([0.3, 0.3], dev, f)) ** 2
    landmarks = _float_on([[10.0, 0.0], [0.0, 10.0], [10.0, 10.0], [-5.0, 5.0]], dev, f)
    if draws is None:
        g = _generator(generator, 0, dev)
        draws = (torch.randn((n_p, 4), generator=g, dtype=f, device=dev),
                 torch.randn((steps, n_p, 2), generator=g, dtype=f, device=dev),
                 torch.rand((steps, 1), generator=g, dtype=f, device=dev))
    init, pred, unif = (_float_on(d, dev, f) for d in draws)
    # the sinusoid controls and pseudo-noise of every step, made on the host
    ks = np.arange(steps, dtype=np.float64)
    controls = _float_on(np.stack([np.ones(steps), 0.35 * np.sin(0.08 * ks)], -1), dev, f)
    z_noise = _float_on(0.3 * np.stack([np.sin(1.3 * ks), np.cos(0.9 * ks)], -1), dev, f)
    r_noise = _float_on(0.2 * np.sin(0.7 * ks[:, None] + np.arange(4)), dev, f)
    noise_std, range_noise = _float_on([0.2, 0.1], dev, f), _float_on(0.3, dev, f)

    spread = _float_on([0.5, 0.5, 0.2, 0.2], dev, f)
    eye = torch.eye(4, dtype=f, device=dev)
    zero = torch.zeros(4, dtype=f, device=dev)
    # the loop's state: truth, the three Gaussian beliefs, the particles
    state = (zero, zero, eye, zero, eye, zero, eye, init * spread,
             torch.full((n_p,), 1.0 / n_p, dtype=f, device=dev))
    steppers = (ekf_step, ukf_step, ckf_step)

    def step(truth, *rest):
        """One step of every filter: the new state and the four squared
        position errors."""
        gauss, (states, weights), (control, zn, rn, noise, u) = rest[:6], rest[6:8], rest[8:]
        truth = unicycle_propagate(truth, control, dt)
        z = truth[:2] + zn
        new, sq = [], []
        for i, stepper in enumerate(steppers):
            b = stepper(GaussianBelief(gauss[2 * i], gauss[2 * i + 1]), z, control, dt, q, r)
            new += [b.mean, b.cov]
            sq.append(torch.sum((b.mean[:2] - truth[:2]) ** 2))
        ranges = norm2(landmarks - truth[:2]) + rn
        # pf_step with the step's draws: predict, weight, maybe-resample
        pf = pf_predict(ParticleBelief(states, weights), control, dt, noise_std, noise=noise)
        pf = pf_update_ranges(pf, ranges, landmarks, range_noise)
        pf = resample_if_needed(
            pf, None, method=lambda _, w: inverse_cdf(w, systematic_positions(u, n_p)))
        sq.append(torch.sum((pf_estimate(pf).mean[:2] - truth[:2]) ** 2))
        return (truth, *new, pf.states, pf.weights), sq

    inputs = lambda k: (controls[k], z_noise[k], r_noise[k], pred[k], unif[k])  # noqa: E731
    if dev.type == "cuda" and steps:
        # a step reads nothing back: on the card each is one replay of a
        # CUDA graph of it; the loop reads a float a filter a step
        step = Graphed(step, *state, *inputs(0))
    sq = {name: 0.0 for name in ("ekf", "ukf", "ckf", "pf")}
    for k in range(steps):
        state, errs = step(*state, *inputs(k))
        for name, e in zip(sq, errs):
            sq[name] += float(e)
    out = {f"{n}_rmse": float(np.sqrt(sq[n] / steps)) for n in sq}
    out["best"] = min(("ekf", "ukf", "ckf", "pf"), key=lambda n: sq[n])
    return out


# ---------------------------------------------------------------------------
# Grid planners


def headless_grid_planners(device=None, dtype=torch.float32):
    """Grid planner sweep on one map (headless_grid_planners.rs): optimal
    wavefront 4/8-conn, ARA* bound, beam search; reports path costs and the
    anytime suboptimality ordering. Two `plan_grid` calls (B2 each)."""
    from rust_robotics_tpu_torch.planning.grid import grid_from_raster
    from rust_robotics_tpu_torch.planning.incremental import (
        ara_star_plan, beam_search_costs, octile_heuristic)
    from rust_robotics_tpu_torch.planning.wavefront import goal_raster, plan_grid

    dev = resolve_device(device)
    blocked = np.zeros((48, 48), bool)
    blocked[12:40, 16] = True
    blocked[8, 16:40] = True
    blocked[30, 24:46] = True
    free = torch.tensor(~blocked, device=dev)
    grid = grid_from_raster(blocked, resolution=1.0, device=dev, dtype=dtype)
    start, goal = (2.0, 2.0), (45.0, 45.0)
    out = {}
    for conn in (4, 8):
        _, cost = plan_grid(grid, start, goal, connectivity=conn)
        out[f"wavefront_{conn}_cost"] = float(cost)
    _, stage_costs, stage_bounds = ara_star_plan(free, (2, 2), (45, 45), stages=3,
                                                 sweeps_per_stage=16, dtype=dtype)
    out["ara_final_cost"] = float(stage_costs[-1])
    out["ara_final_bound"] = float(stage_bounds[-1])
    goals = goal_raster(free.shape, torch.tensor([45, 45], device=dev))
    hmap = octile_heuristic(free.shape, (2, 2), device=dev, dtype=dtype)
    d_beam, _ = beam_search_costs(free, goals, hmap, beam_width=96)
    out["beam_cost"] = float(d_beam[2, 2])
    out["beam_ge_optimal"] = bool(out["beam_cost"] >= out["wavefront_8_cost"] - 1e-6)
    return out


# ---------------------------------------------------------------------------
# MPPI family (headless_mppi_*.rs)


def _mppi_loop(stage, terminal, x0, steps, cfg, draws, dynamics=None, shift=True):
    """`steps` MPPI plans from x0 (a tensor); plan i draws draws[i]
    [K, H, m]. Reads the state, the stage cost and the ESS once a step.
    On the card a step — the plan, the dynamics, the shift and the stage
    cost — is one replay of a CUDA graph of it (the eager step's kernels). Returns host
    (states [steps+1, n], stage costs [steps], ESS [steps])."""
    from rust_robotics_tpu_torch.control.mppi import (
        double_integrator_dynamics, mppi_plan, shift_nominal)

    dyn = dynamics or double_integrator_dynamics

    def step(state, u, d):
        u, u0, diag = mppi_plan(None, dyn, stage, terminal, state, u, cfg, draws=d)
        state = dyn(state, u0, cfg.dt)
        return state, shift_nominal(u) if shift else u, stage(state, u0), \
            diag.effective_sample_size

    state = x0
    u = torch.zeros((cfg.horizon, len(cfg.noise_sigma)), dtype=x0.dtype, device=x0.device)
    if x0.is_cuda and steps:
        step = Graphed(step, state, u, draws[0])
    states, costs, ess = [_np(x0)], [], []
    for i in range(steps):
        state, u, cost, e = step(state, u, draws[i])
        states.append(_np(state))
        costs.append(float(cost))
        ess.append(float(e))
    return np.stack(states), np.array(costs), np.array(ess)


def _mppi_draws(draws, generator, seed, steps, cfg, f, dev):
    """The loop's normals [steps, K, H, m]: `draws`, else drawn."""
    shape = (steps, cfg.num_samples, cfg.horizon, len(cfg.noise_sigma))
    return _normals(draws, generator, seed, shape, f, dev)


def headless_mppi_double_integrator(steps: int = 60, device=None, dtype=torch.float32,
                                    draws=None, generator=None):
    """Vanilla MPPI on the double integrator (headless_mppi_double_integrator.rs):
    drive to the goal, report final distance + mean ESS. draws [steps, 256,
    25, 2] (JAX's key 0)."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, make_goal_costs

    dev = resolve_device(device)
    goal = _float_on([4.0, 3.0], dev, dtype)
    stage, terminal = make_goal_costs(goal)
    cfg = MPPIConfig(horizon=25, num_samples=256)
    d = _mppi_draws(draws, generator, 0, steps, cfg, dtype, dev)
    tr, _, ess = _mppi_loop(stage, terminal, torch.zeros(4, dtype=dtype, device=dev), steps,
                            cfg, d)
    dist = float(np.linalg.norm(tr[-1, :2] - _np(goal)))
    return {"final_distance": dist, "mean_ess": float(ess.mean()), "goal_reached": bool(dist < 0.3)}


def _wall_obstacles():
    ys = np.linspace(-2.0, 2.2, 9)
    return np.stack([np.full(9, 2.0), ys], axis=-1)


def headless_mppi_terminal_value(steps: int = 70, device=None, dtype=torch.float32, draws=None,
                                 generator=None):
    """Terminal-value-grid MPPI behind a wall (headless_mppi_terminal_value.rs,
    mppi.rs:362): the myopic quadratic terminal stalls at the wall; the
    wavefront-derived value grid routes around its top. Same geometry as
    the pinned mppi-value benchmark. One `wavefront_costs` call (B2).
    draws [steps, 512, 25, 2] (JAX's key 7), shared by both runs."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, make_goal_costs
    from rust_robotics_tpu_torch.control.mppi_value import (
        TerminalValueGrid, make_value_terminal_cost)
    from rust_robotics_tpu_torch.planning.wavefront import goal_raster, wavefront_costs

    dev = resolve_device(device)
    f = dtype
    res, origin, w, h = 0.25, (-2.0, -4.0), 48, 48
    goal_xy = (6.0, 0.0)
    goal = _float_on(goal_xy, dev, f)
    free = np.ones((w, h), bool)
    wall_x = int((2.5 - origin[0]) / res)
    wall_top = int((2.0 - origin[1]) / res)
    free[wall_x:wall_x + 2, :wall_top] = False
    goal_idx = torch.tensor([int((goal_xy[0] - origin[0]) / res),
                             int((goal_xy[1] - origin[1]) / res)], device=dev)
    field = wavefront_costs(torch.tensor(free, device=dev), goal_raster((w, h), goal_idx),
                            dtype=f)
    grid = TerminalValueGrid(_float_on(origin, dev, f), _float_on(res, dev, f), field * res)
    obstacle_pts = np.argwhere(~free) * res + np.asarray(origin) + res / 2
    stage, naive_terminal = make_goal_costs(goal, obstacles=_float_on(obstacle_pts, dev, f),
                                            obstacle_radius=0.4, obstacle_weight=500.0)
    value_terminal = make_value_terminal_cost(grid, weight=30.0)
    cfg = MPPIConfig(horizon=25, num_samples=512, noise_sigma=(0.8, 0.8))
    d = _mppi_draws(draws, generator, 7, steps, cfg, f, dev)
    x0 = torch.zeros(4, dtype=f, device=dev)
    tr_n, _, _ = _mppi_loop(stage, naive_terminal, x0, steps, cfg, d)
    tr_v, _, _ = _mppi_loop(stage, value_terminal, x0, steps, cfg, d)
    dn = float(np.linalg.norm(tr_n[-1, :2] - np.asarray(goal_xy)))
    dv = float(np.linalg.norm(tr_v[-1, :2] - np.asarray(goal_xy)))
    return {"naive_final_distance": dn, "value_final_distance": dv,
            "value_wins": bool(dv <= dn + 1e-6)}


def _value_grid(f, dev):
    from rust_robotics_tpu_torch.control.mppi_value import TerminalValueGrid

    return TerminalValueGrid(values=torch.zeros((48, 48), dtype=f, device=dev),
                             origin=_float_on([-1.0, -3.0], dev, f), resolution=_float_on(0.15, dev, f))


def _episode_costs(stage, tr, f, dev):
    """The stage cost of every visited state after the first, at zero
    control, in one batched call (a sample's cost is batch-invariant)."""
    states = _float_on(tr[1:], dev, f)
    return stage(states, torch.zeros(states.shape[:-1] + (2,), dtype=f, device=dev))


def headless_mppi_value_learning(episodes: int = 4, steps: int = 45, device=None,
                                 dtype=torch.float32, draws=None, generator=None):
    """TD value learning from rollouts (headless_mppi_value_learning.rs,
    mppi.rs:715): episode rollouts update the terminal-value grid; episode
    cost decreases from first to last. draws [episodes, steps, 256, 24, 2]
    (episode e: JAX's key e); else each episode's from `generator`, or a
    generator seeded e."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, make_goal_costs
    from rust_robotics_tpu_torch.control.mppi_value import (
        ValueUpdateConfig, make_value_terminal_cost, update_grid_from_rollout)

    dev = resolve_device(device)
    f = dtype
    goal = _float_on([4.5, 0.0], dev, f)
    stage, _ = make_goal_costs(goal, _float_on(_wall_obstacles(), dev, f), obstacle_radius=0.45)
    grid = _value_grid(f, dev)
    vc = ValueUpdateConfig(learning_rate=0.4, discount=0.97)
    cfg = MPPIConfig(horizon=24, num_samples=256, noise_sigma=(0.8, 0.8))
    ep_costs, deltas = [], []
    for ep in range(episodes):
        terminal = make_value_terminal_cost(grid, weight=1.0)
        d = _mppi_draws(None if draws is None else draws[ep], generator, ep, steps, cfg, f, dev)
        tr, _, _ = _mppi_loop(stage, terminal, _float_on([-0.5, 0.0, 0.0, 0.0], dev, f), steps, cfg, d)
        stage_costs = _episode_costs(stage, tr, f, dev)
        grid, rep = update_grid_from_rollout(grid, _float_on(tr[1:], dev, f), stage_costs, vc)
        ep_costs.append(float(stage_costs.sum()))
        deltas.append(float(rep["mean_abs_delta"]))
    return {"first_episode_cost": ep_costs[0],
            "last_episode_cost": ep_costs[-1],
            "first_td_delta": deltas[0],
            "last_td_delta": deltas[-1],
            # TD updates converge: per-visit value corrections shrink
            "improved": bool(deltas[-1] <= deltas[0])}


def headless_mppi_replay_value_learning(episodes: int = 4, steps: int = 40, device=None,
                                        dtype=torch.float32, draws=None, generator=None):
    """Replay-buffer value learning (headless_mppi_replay_value_learning.rs,
    mppi.rs:715): rollouts land in a fixed-capacity ring; batched replay
    updates train the value grid across episodes. draws [episodes, steps,
    256, 22, 2] (episode e: JAX's key 10 + e)."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, make_goal_costs
    from rust_robotics_tpu_torch.control.mppi_value import (
        ValueUpdateConfig, make_replay_buffer, make_value_terminal_cost, replay_push,
        replay_update_grid)

    dev = resolve_device(device)
    f = dtype
    goal = _float_on([4.0, 0.5], dev, f)
    stage, _ = make_goal_costs(goal, _float_on(_wall_obstacles(), dev, f), obstacle_radius=0.45)
    grid = _value_grid(f, dev)
    buf = make_replay_buffer(capacity=8, horizon=steps, state_dim=4, dtype=f, device=dev)
    vc = ValueUpdateConfig(learning_rate=0.3, discount=0.97)
    cfg = MPPIConfig(horizon=22, num_samples=256, noise_sigma=(0.8, 0.8))
    ep_costs, deltas = [], []
    for ep in range(episodes):
        terminal = make_value_terminal_cost(grid, weight=1.0)
        d = _mppi_draws(None if draws is None else draws[ep], generator, 10 + ep, steps, cfg,
                        f, dev)
        tr, _, _ = _mppi_loop(stage, terminal, _float_on([-0.5, 0.0, 0.0, 0.0], dev, f), steps, cfg, d)
        stage_costs = _episode_costs(stage, tr, f, dev)
        buf = replay_push(buf, _float_on(tr[1:], dev, f), stage_costs)
        grid, rep = replay_update_grid(buf, grid, vc)
        ep_costs.append(float(stage_costs.sum()))
        deltas.append(float(rep["mean_abs_delta"]))
    return {"episodes": episodes, "buffer_count": int(buf.count),
            "first_episode_cost": ep_costs[0],
            "last_episode_cost": ep_costs[-1],
            "first_td_delta": deltas[0],
            "last_td_delta": deltas[-1],
            "improved": bool(deltas[-1] <= deltas[0])}


def headless_mppi_adaptive_temperature(steps: int = 50, device=None, dtype=torch.float32,
                                       draws=None, generator=None):
    """ESS-servoed temperature (headless_mppi_adaptive_temperature.rs):
    λ is raised when the effective sample size collapses below the target
    band and lowered when diffuse; reports the λ trace and final ESS
    fraction vs the fixed-λ run. draws [steps, 256, 25, 2] (JAX's key 3),
    shared by both runs."""
    from rust_robotics_tpu_torch.control.mppi import (
        MPPIConfig, double_integrator_dynamics, make_goal_costs, mppi_plan, shift_nominal)

    dev = resolve_device(device)
    f = dtype
    goal = np.array([4.0, 3.0])
    stage, terminal = make_goal_costs(_float_on(goal, dev, f), _float_on(_wall_obstacles(), dev, f),
                                      obstacle_radius=0.45)
    d = _mppi_draws(draws, generator, 3, steps, MPPIConfig(horizon=25, num_samples=256), f, dev)

    def run(adaptive):
        lam = 1.0
        cfg = MPPIConfig(horizon=25, num_samples=256, temperature=lam)
        u = torch.zeros((cfg.horizon, 2), dtype=f, device=dev)
        state = _float_on([-0.5, 0.0, 0.0, 0.0], dev, f)
        ess_frac, lams = [], []
        target = 0.25 * cfg.num_samples
        for i in range(steps):
            u, u0, diag = mppi_plan(None, double_integrator_dynamics, stage, terminal, state, u,
                                    cfg, draws=d[i])
            state = double_integrator_dynamics(state, u0, cfg.dt)
            u = shift_nominal(u)
            ess = float(diag.effective_sample_size)
            ess_frac.append(ess / cfg.num_samples)
            lams.append(lam)
            if adaptive:
                lam = float(np.clip(lam * (1.25 if ess < target else 0.9), 0.05, 20.0))
                cfg = MPPIConfig(horizon=25, num_samples=256, temperature=lam)
        return np.array(ess_frac), np.array(lams), state

    ef_a, lam_a, s_a = run(True)
    ef_f, _, _ = run(False)
    return {"mean_ess_fraction_adaptive": float(ef_a.mean()),
            "mean_ess_fraction_fixed": float(ef_f.mean()),
            "lambda_final": float(lam_a[-1]),
            "lambda_changed": bool(abs(lam_a[-1] - lam_a[0]) > 1e-9),
            "final_distance": float(np.linalg.norm(_np(s_a)[:2] - goal))}


def headless_mppi_constraint_discount(steps: int = 55, device=None, dtype=torch.float32,
                                      draws=None, generator=None):
    """Constraint-discounted MPPI (headless_mppi_constraint_discount.rs):
    obstacle penalty decays along the horizon (near-term constraint
    violations cost more than far-future ones), letting rollouts consider
    late passages through the narrow gap; compares against uniform weight.
    draws [steps, 320, 28, 2] (JAX's key 0), shared by both runs."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, double_integrator_dynamics

    dev = resolve_device(device)
    f = dtype
    goal_np = np.array([4.5, 0.0])
    goal = _float_on(goal_np, dev, f)
    obstacles_np = _wall_obstacles()[:-2]  # open a gap at the top
    obstacles = _float_on(obstacles_np, dev, f)
    cfg = MPPIConfig(horizon=28, num_samples=320, noise_sigma=(0.8, 0.8))
    d = _mppi_draws(draws, generator, 0, steps, cfg, f, dev)

    def dyn_t(state, u, dt):
        # carry the horizon index in state[-1] so the stage cost can
        # discount by lookahead depth
        core = double_integrator_dynamics(state[..., :4], u, dt)
        return torch.cat([core, state[..., 4:] + 1.0], dim=-1)

    def make_stage(discount):
        def stage(state, u):
            pos = state[..., :2]
            t = state[..., 4]
            dist = norm2(pos[..., None, :] - obstacles)
            pen = rsum(torch.clamp(0.45 - dist, min=0.0) ** 2, -1)
            w = 400.0 * discount ** t
            return rsum((pos - goal) ** 2, -1) + w * pen + 0.01 * rsum(u ** 2, -1)
        return stage

    def terminal(state):
        return 10.0 * rsum((state[..., :2] - goal) ** 2, -1)

    out = {}
    for name, disc in (("uniform", 1.0), ("discounted", 0.92)):
        tr, _, _ = _mppi_loop(make_stage(disc), terminal, _float_on([-0.5, 0.0, 0.0, 0.0, 0.0], dev, f),
                              steps, cfg, d, dynamics=dyn_t)
        dist = np.linalg.norm(tr[:, None, :2] - obstacles_np[None], axis=-1)
        out[f"{name}_final_distance"] = float(np.linalg.norm(tr[-1, :2] - goal_np))
        out[f"{name}_min_clearance"] = float(dist.min())
    out["discount_helps_progress"] = bool(
        out["discounted_final_distance"] <= out["uniform_final_distance"] + 0.5)
    return out


def headless_mppi_track_progress(steps: int = 70, device=None, dtype=torch.float32, draws=None,
                                 generator=None):
    """Waypoint-track progress MPPI (headless_mppi_track_progress.rs,
    mppi.rs:362 track grids): terminal value = remaining arc length to the
    track end; reports progress fraction and max lateral error. draws
    [steps, 320, 25, 2] (JAX's key 0)."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig
    from rust_robotics_tpu_torch.control.mppi_value import (
        make_track, make_value_terminal_cost, track_project, track_terminal_value_grid,
        track_total_length)

    dev = resolve_device(device)
    f = dtype
    wps = np.stack([np.linspace(0.0, 8.0, 9), np.sin(np.linspace(0.0, 8.0, 9))], -1)
    track = make_track(_float_on(wps, dev, f))
    grid = track_terminal_value_grid(track, 64, 48, (-1.0, -3.0), 0.15, progress_weight=4.0,
                                     lateral_weight=2.0)
    terminal = make_value_terminal_cost(grid, weight=3.0)

    def stage(state, u):
        _, lat, _ = track_project(track, state[..., :2])
        return (2.0 * lat ** 2 + 0.01 * rsum(u ** 2, -1)
                + 0.5 * torch.clamp(1.5 - state[..., 2], min=0.0) ** 2)

    cfg = MPPIConfig(horizon=25, num_samples=320, noise_sigma=(0.7, 0.7))
    d = _mppi_draws(draws, generator, 0, steps, cfg, f, dev)
    tr, _, _ = _mppi_loop(stage, terminal, torch.zeros(4, dtype=f, device=dev), steps, cfg, d)
    arc, lat, _ = track_project(track, _float_on(tr[:, :2], dev, f))
    total = float(track_total_length(track))
    progress = float(arc[-1]) / total
    return {"progress_fraction": progress,
            "max_lateral_error": float(torch.max(torch.abs(lat))),
            "track_length": total,
            "completed": bool(progress > 0.8)}


def headless_mppi_racing_gate_progress(steps: int = 90, device=None, dtype=torch.float32,
                                       draws=None, generator=None):
    """Powertrain-aware gate race (headless_mppi_racing_gate_progress.rs):
    motor-level quadrotor MPPI through two gates; reports gates passed,
    lap fraction, saturation and SOC (racing.rs powertrain family). draws
    [steps, 128, 15, 4] (JAX's key 0 split into `steps` keys)."""
    from rust_robotics_tpu_torch.control.racing import (
        GatePlane, PowertrainParams, simulate_gate_race)

    dev = resolve_device(device)
    gates = [GatePlane(center=(3.0, 0.0, 1.5), normal=(1.0, 0.0, 0.0), half_width=1.2,
                       half_height=1.2),
             GatePlane(center=(6.0, 0.0, 1.5), normal=(1.0, 0.0, 0.0), half_width=1.2,
                       half_height=1.2)]
    p = PowertrainParams(motor_tau=0.05, discharge_rate=0.05, sag_coeff=0.15)
    d = _normals(draws, generator, 0, (steps, 128, 15, 4), dtype, dev)
    rep = simulate_gate_race(None, gates, p, steps=steps, num_samples=128, horizon=15,
                             aware=True, draws=d, dtype=dtype, device=dev)
    return {"gates_passed": int(rep["gates_passed"]),
            "lap_fraction": float(rep["lap_fraction"]),
            "mean_speed": float(rep["mean_speed"]),
            "saturation_fraction": float(rep["saturation_fraction"]),
            "final_soc": float(rep["final_soc"])}


def headless_adap_rpf_mppi(steps: int = 34, device=None, dtype=torch.float32, draws=None,
                           generator=None):
    """Adaptive following-point person-following MPPI
    (headless_adap_rpf_mppi.rs): a pedestrian occupies the fixed trailing
    point; the adaptive sampler scores candidate following points by
    occlusion + proximity and MPPI tracks the winner. Reports both runs'
    final distance / clearance / occlusion. draws [steps, 360, 16, 2]
    (JAX's key 5), shared by both runs."""
    from rust_robotics_tpu_torch.control.mppi import (
        MPPIConfig, double_integrator_dynamics, mppi_plan, shift_nominal)
    from rust_robotics_tpu_torch.control.mppi_variants import make_person_following_costs

    dev = resolve_device(device)
    f = dtype
    dt = 0.1
    cfg = MPPIConfig(horizon=16, num_samples=360, dt=dt, noise_sigma=(0.6, 0.6))
    d = _mppi_draws(draws, generator, 5, steps, cfg, f, dev)
    ks = np.arange(steps + cfg.horizon + 1)
    target = np.stack([0.6 * ks * dt + 1.5, np.zeros_like(ks, float)], -1)
    pedestrian = np.array([0.0, 0.0]) + target - np.array([1.5, 0.0])

    def segment_point_dist(a, b, p):
        ab = b - a
        t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-9), 0.0, 1.0)
        return float(np.linalg.norm(a + t * ab - p))

    def run(adaptive):
        standoff = 1.5
        offsets = ([np.array([-standoff, 0.0]),
                    np.array([-standoff * 0.7, standoff * 0.7]),
                    np.array([-standoff * 0.7, -standoff * 0.7])]
                   if adaptive else [np.array([-standoff, 0.0])])
        state = _float_on([-2.0, 1.0, 0.0, 0.0], dev, f)
        u = torch.zeros((cfg.horizon, 2), dtype=f, device=dev)
        occl, prox, ess, clear = [], [], [], []
        pos = _np(state[:2])
        for k in range(steps):
            ped = pedestrian[k]
            tgt = target[k]
            # score candidate following points: occlusion = pedestrian near
            # the robot->target sight line; proximity = pedestrian distance
            best, best_score = None, None
            for off in offsets:
                fp = tgt + off
                o = max(0.0, 1.2 - segment_point_dist(fp, tgt, ped))
                p = max(0.0, 1.2 - np.linalg.norm(fp - ped))
                score = o + p + 0.1 * np.linalg.norm(fp - pos)
                if best_score is None or score < best_score:
                    best, best_score, bo, bp = fp, score, o, p
            occl.append(bo)
            prox.append(bp)
            fp_traj = _float_on(target[k:k + cfg.horizon] + (best - tgt), dev, f)
            stage, terminal = make_person_following_costs(fp_traj, standoff=0.0)
            u, u0, diag = mppi_plan(None, double_integrator_dynamics, stage, terminal, state, u,
                                    cfg, draws=d[k])
            state = double_integrator_dynamics(state, u0, dt)
            u = shift_nominal(u)
            ess.append(float(diag.effective_sample_size))
            pos = _np(state[:2])
            clear.append(float(np.linalg.norm(pos - ped)))
        return {"final_distance": float(np.linalg.norm(pos - target[steps])),
                "min_clearance": float(np.min(clear)),
                "mean_occlusion": float(np.mean(occl)),
                "mean_proximity": float(np.mean(prox)),
                "mean_ess": float(np.mean(ess))}

    fixed = run(False)
    adap = run(True)
    return {**{f"fixed_{k}": v for k, v in fixed.items()},
            **{f"adaptive_{k}": v for k, v in adap.items()},
            "adaptive_less_occluded": bool(
                adap["mean_occlusion"] <= fixed["mean_occlusion"] + 1e-9)}


# ---------------------------------------------------------------------------
# Factor-graph stack


def headless_factor_graph_stack(device=None, dtype=torch.float32, draws=None, generator=None):
    """End-to-end Lie/factor-graph smoke (headless_factor_graph_stack.rs):
    g2o SE(2) pose graph terminal error, stationary IMU drift, BA mean
    point error, point-to-plane ICP transform error. draws: (the ICP cloud,
    uniforms [160, 3] on [-2, 2), and normals [160, 3]), as JAX's key 2
    split gives them; else drawn (seeded 2)."""
    from rust_robotics_tpu_torch.core.lie import se3_exp
    from rust_robotics_tpu_torch.slam.bundle_adjustment import CameraIntrinsics, bundle_adjust
    from rust_robotics_tpu_torch.slam.g2o import parse_g2o, se2_arrays
    from rust_robotics_tpu_torch.slam.imu import predict_nav_state, preintegrate
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d
    from rust_robotics_tpu_torch.slam.scan_matching import point_to_plane_icp

    dev = resolve_device(device)
    f = dtype
    g = parse_g2o(
        "VERTEX_SE2 0 0 0 0\n"
        "VERTEX_SE2 1 1.12 -0.08 0.05\n"
        "VERTEX_SE2 2 2.15 0.12 -0.04\n"
        "EDGE_SE2 0 1 1 0 0 100 0 0 100 0 100\n"
        "EDGE_SE2 1 2 1 0 0 100 0 0 100 0 100\n"
        "EDGE_SE2 0 2 2 0 0 100 0 0 100 0 100\n")
    poses, ef, et, meas, info = se2_arrays(g)
    opt, _ = optimize_pose_graph_2d(poses, ef, et, meas, info, device=dev, dtype=f)
    pg_err = float(norm2(opt[2, :2] - _float_on([2.0, 0.0], dev, f)))

    # stationary IMU: gravity-cancelling accel, zero gyro -> no drift
    n = 50
    accels = _float_on([0.0, 0.0, 9.81], dev, f).expand(n, 3)
    gyros = torch.zeros((n, 3), dtype=f, device=dev)
    dts = torch.full((n,), 0.01, dtype=f, device=dev)
    pre = preintegrate(accels, gyros, dts, torch.zeros(6, dtype=f, device=dev), 1e-3, 1e-4)
    nav1 = predict_nav_state(pre, torch.zeros(9, dtype=f, device=dev),
                             torch.zeros(6, dtype=f, device=dev))
    imu_drift = float(torch.sqrt(rsum(nav1[3:9] ** 2, -1)))

    # two cameras over 8 points, perturbed second camera + points
    intr = CameraIntrinsics(500.0, 500.0, 320.0, 240.0)
    pts = _float_on([[0.0, 0.0, 5.0], [1.0, 0.5, 6.0], [-1.0, 0.2, 5.5],
              [0.5, -0.8, 7.0], [-0.6, 0.9, 6.5], [0.2, 0.3, 5.2],
              [0.9, -0.4, 5.8], [-0.8, -0.6, 6.2]], dev, f)
    tangents = _float_on([[0.0] * 6, [0.3, 0.0, 0.0, 0.0, 0.02, 0.0]], dev, f)
    cams = se3_exp(tangents)  # [2, 4, 4] camera-to-world
    # the 16 observations at once: camera-major, a point each
    cam_idx = torch.arange(2, device=dev).repeat_interleave(pts.shape[0])
    pt_idx = torch.arange(pts.shape[0], device=dev).repeat(2)
    rot = cams[cam_idx, :3, :3]
    rel = pts[pt_idx] - cams[cam_idx, :3, 3]
    # pc = Rᵀ (pw − t), as explicit products
    pc = [rel[:, 0] * rot[:, 0, j] + rel[:, 1] * rot[:, 1, j] + rel[:, 2] * rot[:, 2, j]
          for j in range(3)]
    pix = torch.stack([intr.fx * pc[0] / pc[2] + intr.cx, intr.fy * pc[1] / pc[2] + intr.cy], -1)
    noisy = pts + 0.05 * torch.sin(torch.arange(pts.numel(), dtype=f, device=dev)).reshape(
        pts.shape)
    _, ba_pts, _ = bundle_adjust(cams, noisy, cam_idx.to(torch.int32), pt_idx.to(torch.int32),
                                 pix, intr, device=dev, dtype=f)
    ba_err = float(torch.mean(torch.sqrt(rsum((ba_pts - pts) ** 2, -1))))

    # point-to-plane ICP with a known SE(3) offset: cur = exp(-xi) prev,
    # so the previous-from-current estimate recovers +xi
    if draws is None:
        gen = _generator(generator, 2, dev)
        draws = (torch.rand((160, 3), generator=gen, dtype=f, device=dev) * 4.0 - 2.0,
                 torch.randn((160, 3), generator=gen, dtype=f, device=dev))
    prev, raw_n = (_float_on(x, dev, f) for x in draws)
    normals = raw_n / torch.sqrt(rsum(raw_n ** 2, -1))[:, None]
    xi_true = _float_on([0.0, 0.0, 0.03, 0.02, -0.015, 0.05], dev, f)
    tf = se3_exp(-xi_true)
    cur = prev @ tf[:3, :3].T + tf[:3, 3]
    xi_est, _ = point_to_plane_icp(prev, normals, cur)
    icp_err = float(torch.sqrt(rsum((xi_est - xi_true) ** 2, -1)))

    return {"pose_graph_terminal_error": pg_err,
            "stationary_imu_drift": imu_drift,
            "bundle_adjustment_mean_point_error": ba_err,
            "point_to_plane_icp_transform_error": icp_err,
            "status_ok": bool(pg_err < 0.2 and imu_drift < 1e-6 and ba_err < 0.1)}


# ---------------------------------------------------------------------------
# Temporal / multi-agent planners


def headless_conformal_sipp(device=None, dtype=torch.float32):
    """Conformal-SIPP replay (headless_conformal_sipp.rs): plan through a
    predicted crossing obstacle at 0.9 confidence; report arrival, min
    confidence and the violation bound."""
    from rust_robotics_tpu_torch.planning.conformal import conformal_sipp_plan

    dev = resolve_device(device)
    w = h = 12
    blocked = np.zeros((w, h), bool)
    t_len = 16
    ts = np.arange(t_len)
    pred = np.stack([np.full(t_len, 6.0), ts.astype(float)], -1)[None]
    errs = torch.full((t_len, 8), 0.5, dtype=dtype, device=dev)
    out = conformal_sipp_plan(blocked, pred, errs, (2, 0), (5, 11), required_confidence=0.9,
                              obstacle_radius=0.6, device=dev, dtype=dtype)
    assert out is not None
    return {"arrival": int(out["arrival"]),
            "min_confidence": float(out["min_confidence"]),
            "trajectory_violation_bound": float(out["trajectory_violation_bound"]),
            "feasible": True}


def _corridor_map(w=16, h=9):
    free = np.ones((w, h), bool)
    free[6, 2:7] = False
    free[10, 0:5] = False
    return free


def headless_stl_cbs_multi_robot(device=None, dtype=torch.float32):
    """STL-CBS multi-robot plan (headless_stl_cbs_multi_robot.rs): three
    robots with crossing routes, separation >= 1; reports makespan, total
    cost and min pairwise separation."""
    from rust_robotics_tpu_torch.planning.stl import stl_cbs_plan

    dev = resolve_device(device)
    starts = [(0, 1), (0, 7), (15, 4)]
    goals = [(15, 7), (15, 1), (0, 4)]
    out = stl_cbs_plan(_corridor_map(), starts, goals, t_max=28, min_separation=1.0,
                       device=dev, dtype=dtype)
    paths = np.stack([_np(p) for p in out["paths"]]).astype(float)
    seps = []
    for i in range(len(starts)):
        for j in range(i + 1, len(starts)):
            seps.append(np.min(np.linalg.norm(paths[i] - paths[j], axis=-1)))
    arrivals = _np(out["arrivals"])
    return {"success": bool(np.all(arrivals >= 0)),
            "makespan": int(arrivals.max()),
            "conflicts_resolved": int(out["conflicts_resolved"]),
            "separation_robustness": float(out["min_pairwise_separation_robustness"]),
            "min_separation": float(np.min(seps))}


def headless_kinodynamic_stl_cbs(device=None, dtype=torch.float32):
    """Kinodynamic STL-CBS (headless_kinodynamic_stl_cbs.rs): speed-2 moves
    reach the goal faster than the speed-1 baseline under the same STL
    avoid region."""
    from rust_robotics_tpu_torch.planning.stl import (
        StlRectangle, kinodynamic_stl_cbs_plan, stl_cbs_plan)

    dev = resolve_device(device)
    free = _corridor_map()
    avoid = ((StlRectangle(4.0, 6.0, 3.0, 5.0), (0, 25)),)
    slow = stl_cbs_plan(free, [(0, 1)], [(15, 1)], t_max=26, avoid_regions=avoid, device=dev,
                        dtype=dtype)
    fast = kinodynamic_stl_cbs_plan(free, [(0, 1)], [(15, 1)], t_max=26, avoid_regions=avoid,
                                    device=dev, dtype=dtype)
    a_slow = int(_np(slow["arrivals"])[0])
    a_fast = int(_np(fast["arrivals"])[0])
    return {"slow_arrival": a_slow,
            "fast_arrival": a_fast,
            "speedup": bool(0 <= a_fast <= a_slow),
            "both_succeed": bool(a_slow >= 0 and a_fast >= 0),
            "fast_avoid_robustness": float(fast["avoid_robustness"][0])}


def headless_hierarchical_mapf_replanning(device=None, dtype=torch.float32):
    """Hierarchical MAPF with replanning (headless_hierarchical_mapf_replanning.rs):
    region-level plan, then a corridor closure forces a replan whose
    makespan is >= the original."""
    from rust_robotics_tpu_torch.planning.stl import hierarchical_mapf_plan

    dev = resolve_device(device)
    free = np.ones((24, 24), bool)
    free[12, 0:20] = False  # wall with a door at columns 20-23
    starts = [(2, 2), (2, 21)]
    goals = [(21, 21), (21, 2)]
    base = hierarchical_mapf_plan(free, starts, goals, t_max=64, region_size=8, device=dev,
                                  dtype=dtype)
    closed = free.copy()
    closed[12, 20:22] = False  # narrow the door -> forced replanning detour
    re = hierarchical_mapf_plan(closed, starts, goals, t_max=64, region_size=8, device=dev,
                                dtype=dtype)
    b_arr = _np(base["arrivals"])
    r_arr = _np(re["arrivals"])
    return {"base_makespan": int(b_arr.max()),
            "replan_makespan": int(r_arr.max()),
            "base_success": bool(np.all(b_arr >= 0)),
            "replan_success": bool(np.all(r_arr >= 0)),
            "region_conflicts": int(base["region_conflicts"]),
            "replan_not_shorter": bool(r_arr.max() >= b_arr.max())}


# ---------------------------------------------------------------------------
# Risk-graph family


def _ridge_elevation(w=15, h=9):
    x = np.arange(w)[:, None]
    y = np.arange(h)[None, :]
    z = 0.8 * np.exp(-0.5 * ((x - 7) / 1.5) ** 2) * np.ones_like(y, dtype=float)
    z[7, 4] += 1.5  # a blocking step on the ridge crest
    return z


def _path_cells(idx, mask):
    return _np(idx)[_np(mask)]


def headless_traversal_risk_graph(device=None, dtype=torch.float32):
    """Traversal-risk graph planning (headless_traversal_risk_graph.rs):
    plan across ridge terrain at low vs high risk weight; the risk-averse
    path is longer but accumulates less risk."""
    from rust_robotics_tpu_torch.planning.risk_graph import (
        combined_cell_risk, plan_risk_path, terrain_risk_from_elevation)

    dev = resolve_device(device)
    risk = terrain_risk_from_elevation(_ridge_elevation(), blocking_step_height=1.0, device=dev,
                                       dtype=dtype)
    total = _np(combined_cell_risk(risk))
    out = {}
    for name, w in (("direct", 0.0), ("risk_averse", 8.0)):
        idx, mask, cost = plan_risk_path(risk, (0, 4), (14, 4), risk_weight=w)
        p = _path_cells(idx, mask)
        out[f"{name}_cells"] = int(p.shape[0])
        out[f"{name}_cost"] = float(cost)
        out[f"{name}_accumulated_risk"] = float(total[p[:, 0], p[:, 1]].sum())
    out["risk_averse_safer"] = bool(out["risk_averse_accumulated_risk"]
                                    <= out["direct_accumulated_risk"])
    return out


def headless_clearance_risk_graph(device=None, dtype=torch.float32):
    """Clearance-exposure risk planning (headless_clearance_risk_graph.rs):
    adding a clearance channel pushes the path away from walls; reports
    min wall distance with and without the exposure weight."""
    from rust_robotics_tpu_torch.planning.risk_graph import (
        RiskChannels, add_clearance_exposure_risk, clearance_map, plan_risk_path)

    dev = resolve_device(device)
    f = dtype
    w, h = 17, 11
    blocked = np.zeros((w, h), bool)
    blocked[5:12, 5] = True
    zeros = torch.zeros((w, h), dtype=f, device=dev)
    base = RiskChannels(blocked=torch.tensor(blocked, device=dev), traversability=zeros,
                        stability=zeros, exposure=zeros)
    clear = _np(clearance_map(blocked, device=dev, dtype=f))
    risky = add_clearance_exposure_risk(base, minimum_clearance=3.0)
    out = {}
    for name, risk, ew in (("greedy", base, 0.0), ("clearance", risky, 4.0)):
        idx, mask, cost = plan_risk_path(risk, (2, 5), (15, 5), exposure_weight=ew)
        p = _path_cells(idx, mask)
        out[f"{name}_min_clearance"] = float(clear[p[:, 0], p[:, 1]].min())
        out[f"{name}_cost"] = float(cost)
    out["clearance_improved"] = bool(out["clearance_min_clearance"]
                                     >= out["greedy_min_clearance"])
    return out


def headless_elevation_risk_graph(device=None, dtype=torch.float32):
    """Elevation-derived risk planning (headless_elevation_risk_graph.rs):
    slope/roughness risk from a DEM; the blocking step is untraversable and
    the planner reports slope exposure of the chosen path."""
    from rust_robotics_tpu_torch.planning.risk_graph import (
        combined_cell_risk, plan_risk_path, terrain_risk_from_elevation)

    dev = resolve_device(device)
    risk = terrain_risk_from_elevation(_ridge_elevation(), slope_risk_scale=8.0,
                                       blocking_step_height=1.0, device=dev, dtype=dtype)
    idx, mask, cost = plan_risk_path(risk, (0, 0), (14, 8), risk_weight=2.0)
    p = _path_cells(idx, mask)
    total = _np(combined_cell_risk(risk))
    blocked = _np(risk.blocked)
    return {"path_cells": int(p.shape[0]),
            "cost": float(cost),
            "blocked_cells": int(blocked.sum()),
            "path_accumulated_risk": float(total[p[:, 0], p[:, 1]].sum()),
            "avoids_blocked": bool(not blocked[p[:, 0], p[:, 1]].any())}


def headless_risk_map_smoothing(device=None, dtype=torch.float32):
    """Risk-map smoothing (headless_risk_map_smoothing.rs): isolated
    high-risk sensor-noise cells make the planner zigzag; smoothing the
    risk field first shortens the path at comparable accumulated risk."""
    from rust_robotics_tpu_torch.planning.risk_graph import (
        RiskChannels, plan_risk_path, smooth_terrain_risk)

    dev = resolve_device(device)
    f = dtype
    w, h = 13, 7
    r = np.zeros((w, h))
    for (x, y, v) in [(3, 3, 8.0), (6, 3, 8.0), (9, 3, 8.0), (5, 2, 3.0), (7, 4, 3.0)]:
        r[x, y] = v
    blocked = np.zeros((w, h), bool)
    blocked[2, 0] = True
    blocked[10, 6] = True
    zeros = torch.zeros((w, h), dtype=f, device=dev)
    raw = RiskChannels(blocked=torch.tensor(blocked, device=dev),
                       traversability=_float_on(r, dev, f), stability=zeros, exposure=zeros)
    smooth = smooth_terrain_risk(raw, radius_cells=1, iterations=2)
    out = {}
    for name, risk in (("raw", raw), ("smoothed", smooth)):
        idx, mask, cost = plan_risk_path(risk, (0, 3), (12, 3), risk_weight=3.0)
        p = _path_cells(idx, mask)
        turns = int(np.sum(np.any(np.diff(np.diff(p, axis=0), axis=0) != 0, axis=-1)))
        out[f"{name}_cells"] = int(p.shape[0])
        out[f"{name}_turns"] = turns
        out[f"{name}_cost"] = float(cost)
    out["smoothing_straightens"] = bool(out["smoothed_turns"] <= out["raw_turns"])
    return out


def headless_adaptive_costmap_namo(device=None, dtype=torch.float32):
    """Adaptive costmap NAMO (headless_adaptive_costmap_namo.rs): a movable
    obstacle starts as soft cost so the plan takes the center corridor;
    repeated stuck observations raise it to lethal and the same query
    replans around it."""
    from rust_robotics_tpu_torch.planning.risk_graph import (
        NAMO_MOVABLE, NAMO_STATIC, NamoConfig, namo_new, namo_set_state, namo_to_risk,
        namo_update_movable, plan_risk_path)

    dev = resolve_device(device)
    cfg = NamoConfig()
    cm = namo_new(9, 5, device=dev, dtype=dtype)
    # the reference demo's map: movable row blocking the center corridor,
    # two sparse static obstacles; going around is possible but longer
    cm = namo_set_state(cm, torch.tensor([[1, 0], [7, 4]], device=dev), NAMO_STATIC, cfg)
    movable = torch.tensor([[3, 2], [4, 2], [5, 2]], device=dev)
    cm = namo_set_state(cm, movable, NAMO_MOVABLE, cfg)

    risk0 = namo_to_risk(cm, block_lethal_movable=True, cfg=cfg)
    idx0, m0, c0 = plan_risk_path(risk0, (0, 2), (8, 2), risk_weight=0.005)
    p0 = _path_cells(idx0, m0)
    through0 = bool(((p0[:, 0] == 4) & (p0[:, 1] == 2)).any())

    stuck = 0
    while float(cm[1][4, 2]) < cfg.lethal_cost:
        cm, _ = namo_update_movable(cm, movable, commanded_speed=0.5, actual_speed=0.01,
                                    odom_delta=0.0, cfg=cfg)
        stuck += 1
    risk1 = namo_to_risk(cm, block_lethal_movable=True, cfg=cfg)
    idx1, m1, c1 = plan_risk_path(risk1, (0, 2), (8, 2), risk_weight=0.005)
    m1 = _np(m1)
    p1 = _np(idx1)[m1]
    through1 = bool(((p1[:, 0] == 4) & (p1[:, 1] == 2)).any())
    return {"initial_through_corridor": through0,
            "stuck_observations_to_lethal": stuck,
            "replanned_through_corridor": through1,
            "replanned_around": bool(not through1 and m1.any()),
            "initial_cost": float(c0), "replanned_cost": float(c1)}


# ---------------------------------------------------------------------------
# Driving / rigid-body


def headless_branchout_multimodal_driving(device=None, dtype=torch.float32):
    """Branchout multimodal driving (headless_branchout_multimodal_driving.rs):
    closed-loop overtake around a slow obstacle; reports completion, TTC
    margin and comfort from `simulate_closed_loop`."""
    from rust_robotics_tpu_torch.planning.branchout import BranchOutScene, simulate_closed_loop

    dev = resolve_device(device)
    scene = BranchOutScene.simple_overtake()
    rep = simulate_closed_loop(scene, obstacle_velocities=((0.4, 0.0),), steps=40, dtype=dtype,
                               device=dev)
    return {"route_completion": float(rep["route_completion"]),
            "reached_goal": bool(rep["reached_goal"]),
            "no_collision_rate": float(rep["no_collision_rate"]),
            "min_clearance": float(rep["min_clearance"]),
            "min_time_to_collision": float(rep["min_time_to_collision"]),
            "mean_comfort_cost": float(rep["mean_comfort_cost"]),
            "modes_used": len(set(rep["mode_sequence"]))}


def headless_rigid_body_mip_planning(device=None, dtype=torch.float32):
    """Rigid-body MIP-style planning (headless_rigid_body_mip_planning.rs):
    SE(2) lattice plan with per-pose separation certificates through a slot
    between two boxes; reports plan length, min margin, certificate count."""
    from rust_robotics_tpu_torch.planning.rigid_body import (
        RigidBodyConfig, aabb_obstacle, rigid_body_lattice_plan)

    dev = resolve_device(device)
    cfg = RigidBodyConfig(position_step=0.5, heading_count=8)
    # two boxes leaving a 1.2-wide horizontal slot at y in [4.4, 5.6]
    obstacles = (aabb_obstacle(3.0, 4.5, 0.0, 4.4, dtype=dtype, device=dev),
                 aabb_obstacle(3.0, 4.5, 5.6, 10.0, dtype=dtype, device=dev))
    out = rigid_body_lattice_plan((1.0, 5.0, 0.0), (9.0, 5.0, 0.0), obstacles, cfg, dtype=dtype,
                                  device=dev)
    poses = _np(out["poses"])
    return {"reached": bool(np.isfinite(float(out["total_cost"]))),
            "plan_poses": int(poses.shape[0]),
            "path_length": float(out["path_length"]),
            "heading_change": float(out["heading_change"]),
            "min_separation_margin": float(out["min_separation_margin"]),
            "certified": bool(float(out["min_separation_margin"]) > cfg.clearance - 1e-9),
            "cost": float(out["total_cost"])}


# ---------------------------------------------------------------------------
# Registry


def _existing():
    from rust_robotics_tpu_torch.demos.headless import (
        headless_euroc_vio, headless_mission_recovery, headless_navigation_loop)
    return {"headless_navigation_loop": headless_navigation_loop,
            "headless_mission_recovery": headless_mission_recovery,
            "headless_euroc_vio": headless_euroc_vio}


HEADLESS = {
    "headless_localizers": headless_localizers,
    "headless_grid_planners": headless_grid_planners,
    "headless_mppi_double_integrator": headless_mppi_double_integrator,
    "headless_mppi_terminal_value": headless_mppi_terminal_value,
    "headless_mppi_value_learning": headless_mppi_value_learning,
    "headless_mppi_replay_value_learning": headless_mppi_replay_value_learning,
    "headless_mppi_adaptive_temperature": headless_mppi_adaptive_temperature,
    "headless_mppi_constraint_discount": headless_mppi_constraint_discount,
    "headless_mppi_track_progress": headless_mppi_track_progress,
    "headless_mppi_racing_gate_progress": headless_mppi_racing_gate_progress,
    "headless_adap_rpf_mppi": headless_adap_rpf_mppi,
    "headless_factor_graph_stack": headless_factor_graph_stack,
    "headless_conformal_sipp": headless_conformal_sipp,
    "headless_stl_cbs_multi_robot": headless_stl_cbs_multi_robot,
    "headless_kinodynamic_stl_cbs": headless_kinodynamic_stl_cbs,
    "headless_hierarchical_mapf_replanning": headless_hierarchical_mapf_replanning,
    "headless_traversal_risk_graph": headless_traversal_risk_graph,
    "headless_clearance_risk_graph": headless_clearance_risk_graph,
    "headless_elevation_risk_graph": headless_elevation_risk_graph,
    "headless_risk_map_smoothing": headless_risk_map_smoothing,
    "headless_adaptive_costmap_namo": headless_adaptive_costmap_namo,
    "headless_branchout_multimodal_driving": headless_branchout_multimodal_driving,
    "headless_rigid_body_mip_planning": headless_rigid_body_mip_planning,
}


def run_headless(name, **kwargs):
    """Run one headless demo by reference example name; `kwargs` (device,
    dtype, draws, ...) go to the demo."""
    table = dict(HEADLESS)
    table.update(_existing())
    return table[name](**kwargs)
