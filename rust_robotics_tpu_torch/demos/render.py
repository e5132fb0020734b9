"""Render demo family: the reference's render_*_svg / render_gif_* media
generators (SURVEY.md §2.11: 15 SVG + 7 GIF examples, all deterministic
closed-loop sims feeding the software rasterizer — §3.2 call stack).

The port of rust_robotics_tpu/demos/render.py. Each function runs its sim
on `device` (default cuda) in `dtype` (default float64) and writes media
through `viz.raster` (Frame/GifRecorder for GIFs, through the native
encoder where it is built; SvgCanvas for SVGs). Where the JAX render draws
from a PRNG key, the port takes `draws=` (the values JAX's split keys
give, laid out as each docstring says) or a CPU `torch.Generator`; without
either it draws from a CPU generator seeded with JAX's key number, so a
render's own draws are the same on every device. `RENDERS` holds the same
25 names as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device
from rust_robotics_tpu_torch._numeric import norm2
from rust_robotics_tpu_torch.viz.raster import CanvasConfig, Frame, GifRecorder, SvgCanvas

__all__ = [
    "RENDERS",
    "render_gif_ekf_localization",
    "render_gif_particle_filter",
    "render_gif_dwa_navigation",
    "render_svg_path_planning",
    "render_svg_rrt",
    "render_svg_pose_graph",
    "render_svg_dubins",
    "render_svg_any_angle",
]

F64 = torch.float64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _draws(draws, generator, seed, make):
    """`draws`, else make(generator) (else a CPU generator seeded `seed`)."""
    if draws is not None:
        return draws
    return make(generator if generator is not None else torch.Generator().manual_seed(seed))


def _on(draws, dev, f):
    if isinstance(draws, (tuple, list)):
        return type(draws)(_on(d, dev, f) for d in draws)
    return _float_on(draws, dev, f)


def _mppi_normals(steps, k, h):
    return lambda g: torch.randn((steps, k, h, 2), generator=g, dtype=F64)


def render_gif_ekf_localization(path, steps: int = 120, frame_stride: int = 3, device=None,
                                dtype=F64):
    """GIF of the deterministic EKF localization demo — the §3.2 call
    stack (render_gif_ekf_localization.rs:35-110): truth + estimate traces
    and the covariance ellipse, every `frame_stride` steps."""
    from rust_robotics_tpu_torch.demos.ekf_localization import run_ekf_localization_demo

    out = run_ekf_localization_demo(steps=steps, device=device, dtype=dtype)
    truth = _np(out["truth"])
    est = _np(out["estimate"])
    covs = _np(out["cov"])
    cfg = CanvasConfig(width=320, height=320, x_range=(-12, 12), y_range=(-12, 12))
    rec = GifRecorder(path, cfg)
    for k in range(0, steps, frame_stride):
        fr = Frame(cfg)
        fr.draw_path_xy(truth[: k + 1, 0], truth[: k + 1, 1], (0, 0, 255))
        fr.draw_path_xy(est[: k + 1, 0], est[: k + 1, 1], (255, 0, 0))
        # covariance ellipse via eigendecomposition of the 2x2 position
        # block (render_gif_ekf_localization.rs:26-33)
        p = covs[k][:2, :2]
        w, v = np.linalg.eigh(p)
        ang = np.linspace(0, 2 * np.pi, 32)
        ell = (v @ np.diag(np.sqrt(np.maximum(w, 0))) @
               np.stack([np.cos(ang), np.sin(ang)])) * 3.0
        fr.draw_path_xy(est[k, 0] + ell[0], est[k, 1] + ell[1], (0, 160, 0))
        fr.draw_robot(truth[k, 0], truth[k, 1], truth[k, 2], 0.8, (0, 0, 0))
        rec.add_frame(fr)
    return rec.finish()


def render_gif_particle_filter(path, steps: int = 90, frame_stride: int = 3,
                               num_particles: int = 400, device=None, dtype=F64, draws=None,
                               generator=None):
    """GIF of range-only particle-filter localization (the reference's
    render_gif_particle_filter family): particle cloud, truth, estimate,
    and the four RFID landmarks (particle_filter.rs:26-60 demo problem).

    draws (init [P, 4] normals of k0, predict [steps, P, 2] normals and
    resample [steps, 1] uniforms: PRNGKey(3) splits off k0, then a subkey
    a step, which `pf_step` splits into its predict and resample keys)."""
    from rust_robotics_tpu_torch.filters.particle import (
        ParticleBelief, inverse_cdf, pf_estimate, pf_predict, pf_update_ranges,
        resample_if_needed, systematic_positions)

    dev, f = resolve_device(device), dtype
    n_p = num_particles
    init, pred, unif = _on(_draws(draws, generator, 3, lambda g: (
        torch.randn((n_p, 4), generator=g, dtype=F64),
        torch.randn((steps, n_p, 2), generator=g, dtype=F64),
        torch.rand((steps, 1), generator=g, dtype=F64))), dev, f)
    landmarks = _float_on([[10.0, 0.0], [10.0, 10.0], [0.0, 15.0], [-5.0, 20.0]], dev, f)
    dt = 0.1
    belief = ParticleBelief(init * 0.5, torch.full((n_p,), 1.0 / n_p, dtype=f, device=dev))
    truth = torch.zeros(4, dtype=f, device=dev)
    control = _float_on([1.0, 0.1], dev, f)
    noise_std = _float_on([0.2, 0.05], dev, f)
    wiggle = _float_on(np.arange(4), dev, f)
    zero = torch.zeros((), dtype=f, device=dev)

    cfg = CanvasConfig(width=320, height=320, x_range=(-12, 16), y_range=(-6, 22))
    rec = GifRecorder(path, cfg)
    truth_trace, est_trace = [], []
    lm = _np(landmarks)
    for k in range(steps):
        yaw, v = truth[2], control[0]
        truth = truth + dt * torch.stack([v * torch.cos(yaw), v * torch.sin(yaw), control[1],
                                          zero])
        ranges = norm2(landmarks - truth[:2]) + 0.1 * torch.sin(0.9 * k + wiggle)  # sinusoid
        # pf_step with the step's draws: predict, weight, maybe-resample
        belief = pf_predict(belief, control, dt, noise_std, noise=pred[k])
        belief = pf_update_ranges(belief, ranges, landmarks, 0.3)
        belief = resample_if_needed(
            belief, None,
            method=lambda _, w, uk=unif[k]: inverse_cdf(w, systematic_positions(uk, n_p)))
        est = pf_estimate(belief)
        truth_trace.append(_np(truth[:2]))
        est_trace.append(_np(est.mean[:2]))
        if k % frame_stride:
            continue
        fr = Frame(cfg)
        pts = _np(belief.states[:, :2])
        fr.draw_points_xy(pts[:, 0], pts[:, 1], (190, 190, 255), 1.0)
        fr.draw_points_xy(lm[:, 0], lm[:, 1], (0, 0, 0), 3.0)
        tt = np.stack(truth_trace)
        ee = np.stack(est_trace)
        fr.draw_path_xy(tt[:, 0], tt[:, 1], (0, 0, 255))
        fr.draw_path_xy(ee[:, 0], ee[:, 1], (255, 0, 0))
        th = _np(truth)
        fr.draw_robot(float(th[0]), float(th[1]), float(th[2]), 0.8, (0, 0, 0))
        rec.add_frame(fr)
    return rec.finish()


def render_gif_dwa_navigation(path, steps: int = 160, frame_stride: int = 4, device=None,
                              dtype=F64):
    """GIF of the DWA navigation loop (render_gif_dwa family): candidate
    best rollout, obstacle set, traveled path."""
    from rust_robotics_tpu_torch.planning.dwa import DWAConfig, dwa_step, goal_reached, rollout

    dev, f = resolve_device(device), dtype
    cfg_d = DWAConfig()
    goal = _float_on([8.0, 8.0], dev, f)
    obstacles = _float_on([[2.0, 2.5], [4.0, 4.5], [6.0, 5.0], [5.0, 7.0]], dev, f)
    state = torch.zeros(5, dtype=f, device=dev)

    cfg = CanvasConfig(width=320, height=320, x_range=(-1, 10), y_range=(-1, 10))
    rec = GifRecorder(path, cfg)
    trace = [_np(state[:2])]
    ob = _np(obstacles)
    for k in range(steps):
        if bool(goal_reached(state, goal, cfg_d)):
            break
        control, state, _, _ = dwa_step(state, goal, obstacles, cfg_d)
        trace.append(_np(state[:2]))
        if k % frame_stride:
            continue
        fr = Frame(cfg)
        for o in ob:
            fr.draw_circle(o[0], o[1], 0.5, (120, 120, 120))
        tr = np.stack(trace)
        fr.draw_path_xy(tr[:, 0], tr[:, 1], (0, 0, 255))
        ro = _np(rollout(state, control[0], control[1], cfg_d))
        fr.draw_path_xy(ro[:, 0], ro[:, 1], (0, 160, 0))
        fr.draw_circle(8.0, 8.0, 0.3, (200, 0, 0))
        st = _np(state)
        fr.draw_robot(float(st[0]), float(st[1]), float(st[2]), 0.6, (0, 0, 0))
        rec.add_frame(fr)
    return rec.finish()


def render_svg_pose_graph(path, size: int = 300, device=None, dtype=F64):
    """Before/after SVG of 2D pose-graph optimization on the reference's
    benchmark chain (render_svg_pose_graph family): perturbed initialization
    in red, optimized chain in blue, truth in grey."""
    from rust_robotics_tpu_torch.demos.pose_graph_bench import synthesize_chain
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    truth, initial, ef, et, meas, info = synthesize_chain(size)
    poses, _ = optimize_pose_graph_2d(initial, ef, et, meas, info, max_iterations=15,
                                      device=device, dtype=dtype)
    poses = _np(poses)

    x_max = float(truth[:, 0].max()) + 1
    cfg = CanvasConfig(width=600, height=300, x_range=(-1, x_max), y_range=(-3, 3))
    svg = SvgCanvas(cfg)
    svg.draw_path(truth[:, 0], truth[:, 1], (160, 160, 160), 1.0)
    svg.draw_path(initial[:, 0], initial[:, 1], (220, 60, 60), 1.0)
    svg.draw_path(poses[:, 0], poses[:, 1], (0, 0, 255), 1.5)
    return svg.save(path)


def render_svg_dubins(path, device=None, dtype=F64):
    """SVG gallery of Dubins shortest paths for a fan of goal headings
    (render_svg_dubins family)."""
    from rust_robotics_tpu_torch.planning.curves import dubins_shortest_path

    dev = resolve_device(device)
    cfg = CanvasConfig(width=480, height=480, x_range=(-6, 6), y_range=(-6, 6))
    svg = SvgCanvas(cfg)
    start = _float_on([0.0, 0.0, np.pi / 2], dev, dtype)
    colors = [(0, 0, 255), (0, 160, 0), (200, 0, 0), (200, 120, 0), (120, 0, 200)]
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 5, endpoint=False)):
        goal = np.array([4.0 * np.cos(ang), 4.0 * np.sin(ang), ang])
        pts, length, word = dubins_shortest_path(start, _float_on(goal, dev, dtype),
                                                 curvature=1.0)
        pts = _np(pts)
        svg.draw_path(pts[:, 0], pts[:, 1], colors[i % len(colors)], 1.5)
        svg.draw_robot(float(goal[0]), float(goal[1]), float(goal[2]), 0.5, (0, 0, 0))
    svg.draw_robot(0.0, 0.0, np.pi / 2, 0.5, (0, 0, 0))
    return svg.save(path)


def render_svg_any_angle(path, device=None, dtype=F64):
    """SVG comparing the octile grid path, the LOS-shortcut path, and the
    exact corner-visibility optimum on one map (the any-angle family)."""
    from rust_robotics_tpu_torch.planning.any_angle import VisibilityPlanner
    from rust_robotics_tpu_torch.planning.smoothing import shortcut_path
    from rust_robotics_tpu_torch.planning.wavefront import (
        extract_path, goal_raster, wavefront_costs)

    dev = resolve_device(device)
    free = np.ones((40, 40), bool)
    free[10:12, 0:28] = False
    free[24:26, 12:40] = False
    free_t = torch.as_tensor(free, device=dev)
    start = (2, 2)
    goal = (37, 37)
    costs = wavefront_costs(free_t, goal_raster((40, 40), torch.as_tensor(goal, device=dev)),
                            dtype=dtype)
    idx, mask, _ = extract_path(costs, free_t, torch.as_tensor(start, device=dev), max_len=256)
    idx_h, mask_h = _np(idx), _np(mask)
    pts = idx_h[mask_h] + 0.5
    keep, _ = shortcut_path(idx.to(dtype) + 0.5, mask, ~free_t, 0.0, 0.0, 1.0, samples=128)
    sc = idx_h[_np(keep) & mask_h] + 0.5
    vp = VisibilityPlanner(free, samples=128, device=dev, dtype=dtype)
    opt_path = vp.path(np.asarray(start), np.asarray(goal))

    cfg = CanvasConfig(width=480, height=480, x_range=(0, 40), y_range=(0, 40))
    svg = SvgCanvas(cfg)
    ox, oy = np.nonzero(~free)
    svg.draw_points(ox + 0.5, oy + 0.5, (40, 40, 40), 4.0)
    svg.draw_path(pts[:, 0], pts[:, 1], (160, 160, 160), 1.0)
    svg.draw_path(sc[:, 0], sc[:, 1], (0, 160, 0), 1.5)
    if opt_path is not None:
        svg.draw_path(opt_path[:, 0], opt_path[:, 1], (0, 0, 255), 2.0)
    return svg.save(path)


def render_svg_path_planning(path, device=None, dtype=F64):
    """SVG of a wavefront plan around obstacles (render_*_svg family)."""
    from rust_robotics_tpu_torch.planning.grid import grid_from_raster
    from rust_robotics_tpu_torch.planning.wavefront import plan_grid

    blocked = np.zeros((60, 60), bool)
    blocked[20:40, 25] = True
    blocked[20, 25:45] = True
    grid = grid_from_raster(blocked, resolution=1.0, device=device, dtype=dtype)
    p, cost = plan_grid(grid, (5.0, 5.0), (55.0, 55.0))
    pts = _np(p.points)[_np(p.mask) > 0]

    cfg = CanvasConfig(width=480, height=480, x_range=(0, 60), y_range=(0, 60))
    svg = SvgCanvas(cfg)
    ox, oy = np.nonzero(blocked)
    svg.draw_points(ox.astype(float), oy.astype(float), (40, 40, 40), 3.0)
    svg.draw_path(pts[:, 0], pts[:, 1], (0, 0, 255), 2.0)
    svg.draw_circle(5.0, 5.0, 1.0, (0, 160, 0), fill=True)
    svg.draw_circle(55.0, 55.0, 1.0, (200, 0, 0), fill=True)
    return svg.save(path)


_RRT_OBS = np.array([[5.0, 5.0], [3.0, 6.0], [7.0, 4.0]])
_RRT_RAD = np.array([1.0, 0.8, 0.8])


def _rrt_star_tree(seed, device, dtype, draws, generator):
    """The render's RRT* (300 nodes) on draws [299, 3] (`rrt_plan`'s
    uniforms of PRNGKey(seed)): host (nodes, parents, active, path)."""
    from rust_robotics_tpu_torch.planning.rrt import RRTConfig, extract_rrt_path, rrt_plan

    dev = resolve_device(device)
    cfg_r = RRTConfig(expand_dis=1.0, max_nodes=300, connect_radius=2.5, goal_threshold=1.0)
    draws = _on(_draws(draws, generator, seed,
                       lambda g: torch.rand((299, 3), generator=g, dtype=F64)), dev, dtype)
    tree, best, cost = rrt_plan(None, [0.0, 0.0], [10.0, 10.0], _RRT_OBS, _RRT_RAD, cfg_r,
                                star=True, draws=draws, dtype=dtype, device=dev)
    pts, mask = extract_rrt_path(tree, best)
    return (_np(tree.nodes), _np(tree.parents), _np(tree.active), _np(pts)[_np(mask)])


def render_svg_rrt(path, seed: int = 0, device=None, dtype=F64, draws=None, generator=None):
    """SVG of an RRT* tree + best path. draws [299, 3]: `rrt_plan`'s
    uniforms of PRNGKey(seed)."""
    nodes, parents, active, pts = _rrt_star_tree(seed, device, dtype, draws, generator)
    cfg = CanvasConfig(width=480, height=480, x_range=(-2, 12), y_range=(-2, 12))
    svg = SvgCanvas(cfg)
    for o, r in zip(_RRT_OBS, _RRT_RAD):
        svg.draw_circle(o[0], o[1], float(r), (120, 120, 120), fill=True)
    for i in range(len(nodes)):
        if active[i] and parents[i] >= 0:
            a, b = nodes[i], nodes[parents[i]]
            svg.draw_path([a[0], b[0]], [a[1], b[1]], (180, 200, 255), 0.8)
    svg.draw_path(pts[:, 0], pts[:, 1], (255, 0, 0), 2.0)
    return svg.save(path)


# ---------------------------------------------------------------------------
# Round-2 breadth: the remaining reference render_* families
# (Cargo.toml:60-470 — render_gif_pure_pursuit/rrt/slam,
#  render_controller_arena_svg, render_frontier_navigator_svg,
#  render_mppi_value_grid_svg, render_traversal_risk_graph_svg,
#  render_stl_cbs_multi_robot_svg, render_kinodynamic_stl_cbs_svg,
#  render_safe_decode_nav_svg, render_rigid_body_mip_planning_svg,
#  render_branchout_multimodal_driving_svg, render_euroc_vio_svg,
#  render_mppi_track_progress_svg, render_mppi_racing_gate_progress_svg,
#  render_adap_rpf_mppi_svg, render_hierarchical_mapf_replanning_svg)


def _sinusoid_course(n, length, amp, period, dev, f):
    from rust_robotics_tpu_torch._numeric import linspace

    xs = linspace(length, n, dtype=f, device=dev)
    return (torch.stack([xs, amp * torch.sin(xs / period)], dim=-1),
            torch.ones(n, dtype=f, device=dev))


def render_gif_pure_pursuit(path, steps: int = 160, frame_stride: int = 4, device=None,
                            dtype=F64):
    """GIF of pure-pursuit tracking a sinusoid course
    (render_gif_pure_pursuit.rs)."""
    from rust_robotics_tpu_torch.control.trackers import bicycle_kinematics, pure_pursuit_control

    dev = resolve_device(device)
    pts, mask = _sinusoid_course(301, 30.0, 2.0, 5.0, dev, dtype)
    state = _float_on([0.0, -2.0, 0.3, 1.0], dev, dtype)
    traj = [state[:2]]
    for _ in range(steps):
        accel, steer, _ = pure_pursuit_control(state, pts, mask, 3.0)
        state = bicycle_kinematics(state, accel, steer, 0.1, 2.9)
        traj.append(state[:2])
    traj = _np(torch.stack(traj))
    cfg = CanvasConfig(width=480, height=240, x_range=(-2, 32), y_range=(-5, 5))
    rec = GifRecorder(path, cfg)
    course = _np(pts)
    for k in range(0, steps, frame_stride):
        fr = Frame(cfg)
        fr.draw_path_xy(course[:, 0], course[:, 1], (160, 160, 160))
        fr.draw_path_xy(traj[: k + 1, 0], traj[: k + 1, 1], (255, 0, 0))
        fr.draw_robot(traj[k, 0], traj[k, 1],
                      np.arctan2(*(traj[min(k + 1, steps)] - traj[k])[::-1]) if k < steps
                      else 0.0, 0.9, (0, 0, 0))
        rec.add_frame(fr)
    return rec.finish()


def render_gif_rrt(path, seed: int = 0, frame_stride: int = 20, device=None, dtype=F64,
                   draws=None, generator=None):
    """GIF of RRT* tree growth (render_gif_rrt.rs): edges appear in
    insertion order, final best path highlighted. draws [299, 3]:
    `rrt_plan`'s uniforms of PRNGKey(seed)."""
    nodes, parents, active, pts = _rrt_star_tree(seed, device, dtype, draws, generator)
    cfg = CanvasConfig(width=360, height=360, x_range=(-2, 12), y_range=(-2, 12))
    rec = GifRecorder(path, cfg)
    for upto in list(range(frame_stride, len(nodes), frame_stride)) + [len(nodes)]:
        fr = Frame(cfg)
        for o, r in zip(_RRT_OBS, _RRT_RAD):
            fr.draw_circle(o[0], o[1], float(r), (120, 120, 120))
        for i in range(upto):
            if active[i] and 0 <= parents[i] < upto:
                a, b = nodes[i], nodes[parents[i]]
                fr.draw_path_xy([a[0], b[0]], [a[1], b[1]], (150, 180, 255), 0.8)
        rec.add_frame(fr)
    fr = Frame(cfg)
    for o, r in zip(_RRT_OBS, _RRT_RAD):
        fr.draw_circle(o[0], o[1], float(r), (120, 120, 120))
    fr.draw_path_xy(pts[:, 0], pts[:, 1], (255, 0, 0), 2.0)
    rec.add_frame_with_delay(fr, 100)
    return rec.finish()


def render_gif_slam(path, steps: int = 80, frame_stride: int = 4, device=None, dtype=F64):
    """GIF of EKF-SLAM (render_gif_slam.rs): truth vs estimate traces and
    the growing landmark map with covariance ellipses."""
    from rust_robotics_tpu_torch.slam.ekf_slam import ekf_slam_step, init_ekf_slam

    dev, f = resolve_device(device), dtype
    lm = np.array([[6.0, 2.0], [2.0, 6.0], [8.0, 7.0], [-2.0, 3.0], [4.0, -2.0]])
    landmarks = _float_on(lm, dev, f)
    belief = init_ekf_slam(lm.shape[0], dtype=f, device=dev)
    truth = torch.zeros(3, dtype=f, device=dev)
    dt = 0.2
    five = _float_on(np.arange(5), dev, f)
    q_slam = torch.diag(_float_on([0.2, (5 * np.pi / 180) ** 2], dev, f))
    r_slam = torch.diag(_float_on([0.05, 0.01], dev, f) ** 2 * 25)
    t_trace, e_trace = [], []
    frames_data = []
    for k in range(steps):
        control = _float_on([1.0, 0.25 * np.sin(0.07 * k)], dev, f)
        # truth unicycle
        truth = truth + dt * torch.stack([control[0] * torch.cos(truth[2]),
                                          control[0] * torch.sin(truth[2]), control[1]])
        d = landmarks - truth[:2]
        rng = norm2(d)
        brg = torch.atan2(d[:, 1], d[:, 0]) - truth[2]
        obs = torch.stack([rng + 0.05 * torch.sin(0.9 * k + five),
                           brg + 0.01 * torch.cos(1.3 * k + five)], -1)
        visible = rng < 6.0
        belief = ekf_slam_step(belief, control, obs, visible, dt, q_slam, r_slam)
        t_trace.append(truth[:2])
        e_trace.append(belief.mean[:2])
        if k % frame_stride == 0:
            frames_data.append((_np(belief.mean).copy(), _np(belief.cov).copy(), k))
    t_trace, e_trace = _np(torch.stack(t_trace)), _np(torch.stack(e_trace))
    cfg = CanvasConfig(width=360, height=360, x_range=(-5, 12), y_range=(-5, 12))
    rec = GifRecorder(path, cfg)
    for mean, cov, k in frames_data:
        fr = Frame(cfg)
        fr.draw_points_xy(lm[:, 0], lm[:, 1], (0, 0, 0), 3.0)
        fr.draw_path_xy(t_trace[: k + 1, 0], t_trace[: k + 1, 1], (0, 0, 255))
        fr.draw_path_xy(e_trace[: k + 1, 0], e_trace[: k + 1, 1], (255, 0, 0))
        for j in range(lm.shape[0]):
            mx, my = mean[3 + 2 * j], mean[4 + 2 * j]
            p = cov[3 + 2 * j: 5 + 2 * j, 3 + 2 * j: 5 + 2 * j]
            w, v = np.linalg.eigh(p)
            ang = np.linspace(0, 2 * np.pi, 24)
            ell = (v @ np.diag(np.sqrt(np.maximum(w, 0))) @
                   np.stack([np.cos(ang), np.sin(ang)])) * 2.0
            fr.draw_path_xy(mx + ell[0], my + ell[1], (0, 160, 0), 0.8)
        rec.add_frame(fr)
    return rec.finish()


def render_svg_controller_arena(path, steps: int = 300, device=None, dtype=F64):
    """SVG of the tracker arena (render_controller_arena_svg.rs): the shared
    course and each Tier-1 controller's closed-loop trajectory."""
    from rust_robotics_tpu_torch.control.trackers import (
        bicycle_kinematics, lqr_steer_control, pure_pursuit_control, stanley_control)

    dev, f = resolve_device(device), dtype
    pts, mask = _sinusoid_course(401, 40.0, 2.0, 8.0, dev, f)
    zero = torch.zeros((), dtype=f, device=dev)

    def rollout(fn, aux0=None):
        state = _float_on([0.0, -1.0, 0.2, 0.0], dev, f)
        aux = aux0
        traj = [state[:2]]
        for _ in range(steps):
            accel, steer, aux = fn(state, aux)
            state = bicycle_kinematics(state, accel, steer, 0.1, 2.9)
            traj.append(state[:2])
        return _np(torch.stack(traj))

    def stateless(ctl):
        return lambda s, a: (*ctl(s, pts, mask, 3.0)[:2], a)

    runs = {
        "pure_pursuit": (rollout(stateless(pure_pursuit_control)), (255, 0, 0)),
        "stanley": (rollout(stateless(stanley_control)), (0, 160, 0)),
        # LQR threads (e, θe) as controller state (lqr_steer_control.rs)
        "lqr_steer": (rollout(lambda s, a: lqr_steer_control(s, pts, mask, 3.0, a[0], a[1]),
                              aux0=(zero, zero)), (200, 120, 0)),
    }
    cfg = CanvasConfig(width=640, height=240, x_range=(-2, 42), y_range=(-5, 5))
    svg = SvgCanvas(cfg)
    course = _np(pts)
    svg.draw_path(course[:, 0], course[:, 1], (160, 160, 160), 1.0)
    for name, (traj, color) in runs.items():
        svg.draw_path(traj[:, 0], traj[:, 1], color, 1.2)
    return svg.save(path)


def render_svg_frontier_navigator(path, device=None, dtype=F64):
    """SVG of frontier exploration (render_frontier_navigator_svg.rs):
    truth obstacles, the final revealed set, and the executed trajectory."""
    from rust_robotics_tpu_torch.planning.frontier import frontier_navigate

    truth = np.zeros((40, 40), bool)
    truth[15:25, 10:30] = True
    truth[5, 5:35] = True
    out = frontier_navigate(truth, (2, 2), (37, 37), device=device, dtype=dtype)
    traj = np.asarray(_np(out["trajectory"]), float)
    cfg = CanvasConfig(width=400, height=400, x_range=(0, 40), y_range=(0, 40))
    svg = SvgCanvas(cfg)
    bx, by = np.nonzero(truth)
    svg.draw_points(bx + 0.5, by + 0.5, (120, 120, 120), 4.0)
    svg.draw_path(traj[:, 0] + 0.5, traj[:, 1] + 0.5, (255, 0, 0), 1.5)
    svg.draw_robot(traj[-1, 0] + 0.5, traj[-1, 1] + 0.5, 0.0, 1.0, (0, 0, 255))
    return svg.save(path)


def _mppi_traj(dynamics, stage, terminal, state, cfg, draws):
    """The receding-horizon MPPI loop of the MPPI renders: step k plans on
    draws[k]; returns the host xy trajectory."""
    from rust_robotics_tpu_torch.control.mppi import mppi_plan, shift_nominal

    u = torch.zeros((cfg.horizon, 2), dtype=state.dtype, device=state.device)
    traj = [state[:2]]
    for k in range(draws.shape[0]):
        u, first, _ = mppi_plan(None, dynamics, stage, terminal, state, u, cfg, draws=draws[k])
        state = dynamics(state, first, cfg.dt)
        u = shift_nominal(u)
        traj.append(state[:2])
    return _np(torch.stack(traj))


def render_svg_mppi_value_grid(path, device=None, dtype=F64, draws=None, generator=None):
    """SVG of a wavefront terminal-value grid behind a wall with the
    value-guided MPPI trajectory (render_mppi_value_grid_svg.rs): cells
    shaded by cost-to-go band. draws [50, 256, 25, 2]: the normals of the
    50 subkeys split off PRNGKey(7), one a step."""
    from rust_robotics_tpu_torch.control.mppi import (
        MPPIConfig, double_integrator_dynamics, make_goal_costs)
    from rust_robotics_tpu_torch.control.mppi_value import make_value_terminal_cost
    from rust_robotics_tpu_torch.demos.benchmarks import _value_grid, _value_grid_scene

    dev, f = resolve_device(device), dtype
    draws = _on(_draws(draws, generator, 7, _mppi_normals(50, 256, 25)), dev, f)
    free, goal, goal_idx, res, origin = _value_grid_scene(dev, f)
    w, h = free.shape
    grid = _value_grid(free, goal_idx, res, origin, dev, f)
    vals = _np(grid.values)
    stage, _ = make_goal_costs(goal)
    terminal = make_value_terminal_cost(grid, weight=30.0)
    cfg_m = MPPIConfig(horizon=25, num_samples=256, noise_sigma=(0.8, 0.8))
    traj = _mppi_traj(double_integrator_dynamics, stage, terminal,
                      torch.zeros(4, dtype=f, device=dev), cfg_m, draws)
    cfg = CanvasConfig(width=480, height=480, x_range=(-2, 10), y_range=(-4, 8))
    svg = SvgCanvas(cfg)
    finite = np.isfinite(vals)
    bands = np.nanpercentile(vals[finite], [33, 66])
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    wx = xs * res + origin[0] + res / 2
    wy = ys * res + origin[1] + res / 2
    for lo, hi, color in [(-np.inf, bands[0], (200, 230, 200)),
                          (bands[0], bands[1], (250, 230, 160)),
                          (bands[1], np.inf, (250, 190, 190))]:
        m = finite & (vals > lo) & (vals <= hi)
        svg.draw_points(wx[m], wy[m], color, 3.0)
    bx, by = np.nonzero(~free)
    svg.draw_points(bx * res + origin[0] + res / 2, by * res + origin[1] + res / 2,
                    (60, 60, 60), 3.0)
    svg.draw_path(traj[:, 0], traj[:, 1], (255, 0, 0), 2.0)
    svg.draw_circle(6.0, 0.0, 0.3, (0, 0, 255))
    return svg.save(path)


def render_svg_traversal_risk_graph(path, device=None, dtype=F64):
    """SVG of risk-aware planning over ridge terrain
    (render_traversal_risk_graph_svg.rs): risk heat bands, blocked cells,
    direct vs risk-averse paths."""
    from rust_robotics_tpu_torch.demos.headless_family import _ridge_elevation
    from rust_robotics_tpu_torch.planning.risk_graph import (
        combined_cell_risk, plan_risk_path, terrain_risk_from_elevation)

    risk = terrain_risk_from_elevation(_ridge_elevation(), blocking_step_height=1.0,
                                       device=device, dtype=dtype)
    total = _np(combined_cell_risk(risk))
    w, h = total.shape
    cfg = CanvasConfig(width=450, height=270, x_range=(0, w), y_range=(0, h))
    svg = SvgCanvas(cfg)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    for lo, hi, color in [(0.5, 3.0, (250, 230, 160)), (3.0, np.inf, (250, 170, 170))]:
        m = (total > lo) & (total <= hi)
        svg.draw_points(xs[m] + 0.5, ys[m] + 0.5, color, 6.0)
    blk = _np(risk.blocked)
    svg.draw_points(xs[blk] + 0.5, ys[blk] + 0.5, (60, 60, 60), 6.0)
    for weight, color in ((0.0, (200, 0, 0)), (8.0, (0, 0, 255))):
        idx, mask, _ = plan_risk_path(risk, (0, 4), (14, 4), risk_weight=weight)
        p = _np(idx)[_np(mask)]
        svg.draw_path(p[:, 0] + 0.5, p[:, 1] + 0.5, color, 1.8)
    return svg.save(path)


def render_svg_stl_cbs_multi_robot(path, device=None, dtype=F64):
    """SVG of the STL-CBS three-robot solution
    (render_stl_cbs_multi_robot_svg.rs)."""
    from rust_robotics_tpu_torch.demos.headless_family import _corridor_map
    from rust_robotics_tpu_torch.planning.stl import stl_cbs_plan

    free = _corridor_map()
    out = stl_cbs_plan(free, [(0, 1), (0, 7), (15, 4)], [(15, 7), (15, 1), (0, 4)], t_max=28,
                       min_separation=1.0, device=device, dtype=dtype)
    w, h = free.shape
    cfg = CanvasConfig(width=480, height=270, x_range=(0, w), y_range=(0, h))
    svg = SvgCanvas(cfg)
    bx, by = np.nonzero(~free)
    svg.draw_points(bx + 0.5, by + 0.5, (60, 60, 60), 8.0)
    colors = [(255, 0, 0), (0, 160, 0), (0, 0, 255)]
    for i, p in enumerate(np.asarray(_np(out["paths"]), float)):
        svg.draw_path(p[:, 0] + 0.5, p[:, 1] + 0.5, colors[i], 1.5)
    return svg.save(path)


def render_svg_kinodynamic_stl_cbs(path, device=None, dtype=F64):
    """SVG comparing speed-1 vs kinodynamic speed-2 STL-CBS paths
    (render_kinodynamic_stl_cbs_svg.rs)."""
    from rust_robotics_tpu_torch.demos.headless_family import _corridor_map
    from rust_robotics_tpu_torch.planning.stl import (
        StlRectangle, kinodynamic_stl_cbs_plan, stl_cbs_plan)

    free = _corridor_map()
    avoid = ((StlRectangle(4.0, 6.0, 3.0, 5.0), (0, 25)),)
    slow = stl_cbs_plan(free, [(0, 1)], [(15, 1)], t_max=26, avoid_regions=avoid, device=device,
                        dtype=dtype)
    fast = kinodynamic_stl_cbs_plan(free, [(0, 1)], [(15, 1)], t_max=26, avoid_regions=avoid,
                                    device=device, dtype=dtype)
    w, h = free.shape
    cfg = CanvasConfig(width=480, height=270, x_range=(0, w), y_range=(0, h))
    svg = SvgCanvas(cfg)
    bx, by = np.nonzero(~free)
    svg.draw_points(bx + 0.5, by + 0.5, (60, 60, 60), 8.0)
    # the STL geofence
    rect = np.array([[4, 3], [6, 3], [6, 5], [4, 5], [4, 3]], float)
    svg.draw_path(rect[:, 0], rect[:, 1], (250, 170, 170), 1.5)
    for out, color in ((slow, (200, 120, 0)), (fast, (0, 0, 255))):
        p = np.asarray(_np(out["paths"])[0], float)
        a = int(_np(out["arrivals"])[0])
        svg.draw_path(p[: a + 1, 0] + 0.5, p[: a + 1, 1] + 0.5, color, 1.5)
    return svg.save(path)


def render_svg_safe_decode_nav(path, device=None, dtype=F64):
    """SVG of STL-shielded decoding (render_safe_decode_nav_svg.rs): greedy
    vs shielded path around the hazard geofence."""
    from rust_robotics_tpu_torch.planning.stl import StlRectangle, safe_decode_nav

    free = np.ones((12, 12), bool)
    hazard = StlRectangle(3.0, 8.0, 3.0, 8.0)
    out = safe_decode_nav(free, (0, 0), (11, 11), t_max=30, avoid_regions=((hazard, (0, 29)),),
                          device=device, dtype=dtype)
    cfg = CanvasConfig(width=360, height=360, x_range=(0, 12), y_range=(0, 12))
    svg = SvgCanvas(cfg)
    rect = np.array([[3, 3], [8, 3], [8, 8], [3, 8], [3, 3]], float)
    svg.draw_path(rect[:, 0], rect[:, 1], (250, 170, 170), 2.0)
    g = np.asarray(_np(out["greedy_path"]), float)
    s = np.asarray(_np(out["shielded_path"]), float)
    svg.draw_path(g[:, 0] + 0.5, g[:, 1] + 0.5, (200, 120, 0), 1.2)
    svg.draw_path(s[:, 0] + 0.5, s[:, 1] + 0.5, (0, 0, 255), 1.8)
    return svg.save(path)


def render_svg_rigid_body_mip_planning(path, device=None, dtype=F64):
    """SVG of the rigid-body lattice plan through the slot
    (render_rigid_body_mip_planning_svg.rs): obstacle boxes and the
    oriented robot footprint along the path."""
    from rust_robotics_tpu_torch.planning.rigid_body import (
        RigidBodyConfig, aabb_obstacle, rigid_body_lattice_plan)

    dev = resolve_device(device)
    cfg_rb = RigidBodyConfig(position_step=0.5, heading_count=8)
    boxes = ((3.0, 4.5, 0.0, 4.4), (3.0, 4.5, 5.6, 10.0))
    obstacles = tuple(aabb_obstacle(*b, dtype=dtype, device=dev) for b in boxes)
    out = rigid_body_lattice_plan((1.0, 5.0, 0.0), (9.0, 5.0, 0.0), obstacles, cfg_rb)
    poses = _np(out["poses"])
    cfg = CanvasConfig(width=400, height=400, x_range=(0, 10), y_range=(0, 10))
    svg = SvgCanvas(cfg)
    for (x0, x1, y0, y1) in boxes:
        box = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]])
        svg.draw_path(box[:, 0], box[:, 1], (120, 120, 120), 1.5)
    svg.draw_path(poses[:, 0], poses[:, 1], (255, 0, 0), 1.5)
    for p in poses[:: max(1, len(poses) // 10)]:
        svg.draw_robot(p[0], p[1], p[2], 0.55, (0, 0, 255))
    return svg.save(path)


def render_svg_branchout_multimodal_driving(path, device=None, dtype=F64):
    """SVG of the branchout overtake (render_branchout_multimodal_driving_svg.rs):
    lane lines, obstacle, per-mode candidate trajectories, executed path."""
    from rust_robotics_tpu_torch.planning.branchout import (
        BranchOutScene, branchout_plan, simulate_closed_loop)

    scene = BranchOutScene.simple_overtake()
    plan = branchout_plan(scene, dtype=dtype, device=device)
    rep = simulate_closed_loop(scene, obstacle_velocities=((0.4, 0.0),), steps=40, dtype=dtype,
                               device=device)
    executed = np.asarray(_np(rep["executed_path"]), float)
    cfg = CanvasConfig(width=600, height=240, x_range=(-1, 11), y_range=(-2.5, 2.5))
    svg = SvgCanvas(cfg)
    for lane in (-1, 0, 1):
        y = lane * scene.lane_width
        svg.draw_path([-1, 11], [y, y], (200, 200, 200), 0.8)
    for (ox, oy, orr) in np.asarray(scene.obstacles, float):
        svg.draw_circle(ox, oy, orr, (120, 120, 120), fill=True)
    colors = [(200, 120, 0), (0, 160, 0), (0, 0, 255), (160, 0, 200)]
    trajs = np.asarray(_np(plan["poses"]), float)
    for i in range(trajs.shape[0]):
        svg.draw_path(trajs[i, :, 0], trajs[i, :, 1], colors[i % 4], 0.8)
    svg.draw_path(executed[:, 0], executed[:, 1], (255, 0, 0), 2.0)
    return svg.save(path)


def render_svg_euroc_vio(path, device=None, dtype=F64):
    """SVG of the EuRoC fixture VIO replay (render_euroc_vio_svg.rs):
    ground-truth xy track vs dead-reckoned and fused estimates. Returns
    None, writing nothing, where the reference's fixture is absent."""
    from rust_robotics_tpu_torch.data.euroc import EurocDataset
    from rust_robotics_tpu_torch.data.fixtures import reference_fixture_root
    from rust_robotics_tpu_torch.slam.vio import nav_to_se3, run_vio_pipeline

    device = resolve_device(device)
    root = reference_fixture_root("euroc_mini")
    if not root:  # reference checkout absent: nothing to draw
        return None
    ds = EurocDataset.load(root)
    tracks = ds.load_feature_tracks()
    res = run_vio_pipeline(ds, tracks, device=device, dtype=dtype)
    gt = np.asarray(ds.ground_truth.positions, float)
    fused = _np(res.fused_poses)[:, :2, 3]
    dead = _np(nav_to_se3(res.dead_reckoned))[:, :2, 3]
    lo = gt[:, :2].min(0) - 0.5
    hi = gt[:, :2].max(0) + 0.5
    cfg = CanvasConfig(width=480, height=480, x_range=(float(lo[0]), float(hi[0])),
                       y_range=(float(lo[1]), float(hi[1])))
    svg = SvgCanvas(cfg)
    svg.draw_path(gt[:, 0], gt[:, 1], (160, 160, 160), 1.5)
    svg.draw_path(dead[:, 0], dead[:, 1], (200, 120, 0), 1.0)
    svg.draw_path(fused[:, 0], fused[:, 1], (0, 0, 255), 1.5)
    return svg.save(path)


def render_svg_mppi_track_progress(path, device=None, dtype=F64, draws=None, generator=None):
    """SVG of track-progress MPPI (render_mppi_track_progress_svg.rs):
    waypoint track and the value-guided rollout. draws [55, 256, 25, 2]:
    the normals of the 55 subkeys split off PRNGKey(0), one a step."""
    from rust_robotics_tpu_torch.control._small import rsum
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, double_integrator_dynamics
    from rust_robotics_tpu_torch.control.mppi_value import (
        make_track, make_value_terminal_cost, track_project, track_terminal_value_grid)

    dev, f = resolve_device(device), dtype
    draws = _on(_draws(draws, generator, 0, _mppi_normals(55, 256, 25)), dev, f)
    wps = np.stack([np.linspace(0.0, 8.0, 9), np.sin(np.linspace(0.0, 8.0, 9))], -1)
    track = make_track(wps, dtype=f, device=dev)
    grid = track_terminal_value_grid(track, 64, 48, (-1.0, -3.0), 0.15, progress_weight=4.0,
                                     lateral_weight=2.0)
    terminal = make_value_terminal_cost(grid, weight=3.0)

    def stage(state, u):
        arc, lat, _ = track_project(track, state[..., :2])
        return 2.0 * lat ** 2 + 0.01 * rsum(u ** 2, -1)

    cfg_m = MPPIConfig(horizon=25, num_samples=256, noise_sigma=(0.7, 0.7))
    traj = _mppi_traj(double_integrator_dynamics, stage, terminal,
                      torch.zeros(4, dtype=f, device=dev), cfg_m, draws)
    cfg = CanvasConfig(width=540, height=300, x_range=(-1, 9), y_range=(-2.5, 2.5))
    svg = SvgCanvas(cfg)
    svg.draw_path(wps[:, 0], wps[:, 1], (160, 160, 160), 1.5)
    svg.draw_points(wps[:, 0], wps[:, 1], (0, 0, 0), 3.0)
    svg.draw_path(traj[:, 0], traj[:, 1], (255, 0, 0), 1.8)
    return svg.save(path)


def render_svg_mppi_racing_gate_progress(path, device=None, dtype=F64, draws=None,
                                         generator=None):
    """SVG (xy top-down) of the powertrain-aware gate race
    (render_mppi_racing_gate_progress_svg.rs). draws [60, 96, 12, 4]: the
    normals of the 60 step keys split off PRNGKey(0)."""
    from rust_robotics_tpu_torch.control.racing import (
        GatePlane, PowertrainParams, simulate_gate_race)

    dev, f = resolve_device(device), dtype
    draws = _on(_draws(draws, generator, 0,
                       lambda g: torch.randn((60, 96, 12, 4), generator=g, dtype=F64)), dev, f)
    gates = [GatePlane(center=(3.0, 0.0, 1.5), normal=(1.0, 0.0, 0.0), half_width=1.2,
                       half_height=1.2),
             GatePlane(center=(6.0, 0.0, 1.5), normal=(1.0, 0.0, 0.0), half_width=1.2,
                       half_height=1.2)]
    p = PowertrainParams(motor_tau=0.05, discharge_rate=0.05, sag_coeff=0.15)
    rep = simulate_gate_race(None, gates, p, steps=60, num_samples=96, horizon=12, aware=True,
                             draws=draws, dtype=f, device=dev)
    traj = np.asarray(rep["trajectory"], float)
    cfg = CanvasConfig(width=480, height=320, x_range=(-1, 8), y_range=(-3, 3))
    svg = SvgCanvas(cfg)
    for g in gates:
        cx, cy, _ = g.center
        svg.draw_path([cx, cx], [cy - g.half_width, cy + g.half_width], (0, 160, 0), 2.5)
    svg.draw_path(traj[:, 0], traj[:, 1], (255, 0, 0), 1.5)
    svg.draw_robot(traj[-1, 0], traj[-1, 1], 0.0, 0.4, (0, 0, 255))
    return svg.save(path)


def render_svg_adap_rpf_mppi(path, device=None, dtype=F64, draws=None, generator=None):
    """SVG of adaptive following-point person following
    (render_adap_rpf_mppi_svg.rs): target walk, pedestrian, and the robot
    track for fixed vs adaptive sampling. draws [30, 256, 16, 2]: the
    normals of the 30 subkeys split off PRNGKey(5), shared by both runs."""
    from rust_robotics_tpu_torch.control.mppi import MPPIConfig, double_integrator_dynamics
    from rust_robotics_tpu_torch.control.mppi import mppi_plan, shift_nominal
    from rust_robotics_tpu_torch.control.mppi_variants import make_person_following_costs

    dev, f = resolve_device(device), dtype
    steps, dt = 30, 0.1
    draws = _on(_draws(draws, generator, 5, _mppi_normals(steps, 256, 16)), dev, f)
    cfg_m = MPPIConfig(horizon=16, num_samples=256, dt=dt, noise_sigma=(0.6, 0.6))
    ks = np.arange(steps + 17)
    target = np.stack([0.6 * ks * dt + 1.5, np.zeros_like(ks, float)], -1)

    def run(offset):
        state = _float_on([-2.0, 1.0, 0.0, 0.0], dev, f)
        u = torch.zeros((16, 2), dtype=f, device=dev)
        traj = [state[:2]]
        for k in range(steps):
            fp_traj = _float_on(target[k:k + 16] + offset, dev, f)
            stage, terminal = make_person_following_costs(fp_traj, standoff=0.0)
            u, first, _ = mppi_plan(None, double_integrator_dynamics, stage, terminal, state, u,
                                    cfg_m, draws=draws[k])
            state = double_integrator_dynamics(state, first, dt)
            u = shift_nominal(u)
            traj.append(state[:2])
        return _np(torch.stack(traj))

    fixed = run(np.array([-1.5, 0.0]))
    adaptive = run(np.array([-1.05, 1.05]))
    cfg = CanvasConfig(width=540, height=270, x_range=(-3, 6), y_range=(-2, 3))
    svg = SvgCanvas(cfg)
    svg.draw_path(target[:steps, 0], target[:steps, 1], (160, 160, 160), 1.5)
    ped = target[:steps] - np.array([1.5, 0.0])
    svg.draw_path(ped[:, 0], ped[:, 1], (0, 0, 0), 1.0)
    svg.draw_path(fixed[:, 0], fixed[:, 1], (200, 120, 0), 1.5)
    svg.draw_path(adaptive[:, 0], adaptive[:, 1], (0, 0, 255), 1.5)
    return svg.save(path)


def render_svg_hierarchical_mapf_replanning(path, device=None, dtype=F64):
    """SVG of the hierarchical MAPF solution with region grid
    (render_hierarchical_mapf_replanning_svg.rs)."""
    from rust_robotics_tpu_torch.planning.stl import hierarchical_mapf_plan

    free = np.ones((24, 24), bool)
    free[12, 0:20] = False
    out = hierarchical_mapf_plan(free, [(2, 2), (2, 21)], [(21, 21), (21, 2)], t_max=64,
                                 region_size=8, device=device, dtype=dtype)
    cfg = CanvasConfig(width=400, height=400, x_range=(0, 24), y_range=(0, 24))
    svg = SvgCanvas(cfg)
    for r in range(0, 25, 8):  # region boundaries
        svg.draw_path([r, r], [0, 24], (220, 220, 220), 0.6)
        svg.draw_path([0, 24], [r, r], (220, 220, 220), 0.6)
    bx, by = np.nonzero(~free)
    svg.draw_points(bx + 0.5, by + 0.5, (60, 60, 60), 6.0)
    colors = [(255, 0, 0), (0, 0, 255)]
    arrivals = _np(out["arrivals"])
    for i, p in enumerate(np.asarray(_np(out["paths"]), float)):
        a = int(arrivals[i])
        svg.draw_path(p[: a + 1, 0] + 0.5, p[: a + 1, 1] + 0.5, colors[i], 1.5)
    return svg.save(path)


RENDERS = {
    "render_gif_ekf_localization": render_gif_ekf_localization,
    "render_gif_particle_filter": render_gif_particle_filter,
    "render_gif_dwa_navigation": render_gif_dwa_navigation,
    "render_gif_pure_pursuit": render_gif_pure_pursuit,
    "render_gif_rrt": render_gif_rrt,
    "render_gif_slam": render_gif_slam,
    "render_svg_path_planning": render_svg_path_planning,
    "render_svg_rrt": render_svg_rrt,
    "render_svg_pose_graph": render_svg_pose_graph,
    "render_svg_dubins": render_svg_dubins,
    "render_svg_any_angle": render_svg_any_angle,
    "render_svg_controller_arena": render_svg_controller_arena,
    "render_svg_frontier_navigator": render_svg_frontier_navigator,
    "render_svg_mppi_value_grid": render_svg_mppi_value_grid,
    "render_svg_traversal_risk_graph": render_svg_traversal_risk_graph,
    "render_svg_stl_cbs_multi_robot": render_svg_stl_cbs_multi_robot,
    "render_svg_kinodynamic_stl_cbs": render_svg_kinodynamic_stl_cbs,
    "render_svg_safe_decode_nav": render_svg_safe_decode_nav,
    "render_svg_rigid_body_mip_planning": render_svg_rigid_body_mip_planning,
    "render_svg_branchout_multimodal_driving": render_svg_branchout_multimodal_driving,
    "render_svg_euroc_vio": render_svg_euroc_vio,
    "render_svg_mppi_track_progress": render_svg_mppi_track_progress,
    "render_svg_mppi_racing_gate_progress": render_svg_mppi_racing_gate_progress,
    "render_svg_adap_rpf_mppi": render_svg_adap_rpf_mppi,
    "render_svg_hierarchical_mapf_replanning": render_svg_hierarchical_mapf_replanning,
}
