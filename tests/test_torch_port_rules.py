"""Rules the port keeps: it imports neither JAX nor the JAX package (it
keeps its own copy of what it needs), triton only inside the function that
launches a kernel, and its entry points never fall back to the CPU
unasked."""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "rust_robotics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, is top level) for every import in a module."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in top


def _forbidden(module, top_level):
    root = module.split(".")[0]
    if root in ("jax", "jaxlib") or root == "rust_robotics_tpu":
        return True
    return root == "triton" and top_level


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m, top in _imports(tree) if _forbidden(m, top)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_scan_sees_what_it_must():
    tree = ast.parse(
        "import jax.numpy as jnp\nfrom rust_robotics_tpu.core import angles\n"
        "import rust_robotics_tpu_torch\nfrom rust_robotics_tpu_torch.ops import ekf_scan\n"
        "import triton\ndef f():\n    import triton\n"
    )
    flagged = [m for m, top in _imports(tree) if _forbidden(m, top)]
    assert flagged == ["jax.numpy", "rust_robotics_tpu.core", "triton"]
    assert len(PORT_FILES) > 10
    scanned = {str(p.relative_to(ROOT / "rust_robotics_tpu_torch")) for p in PORT_FILES[:-1]}
    assert scanned >= {"data/moving_ai.py"} | {
        f"planning/{m}.py" for m in ("a_star_variants", "any_angle", "fields", "frontier",
                                     "risk_graph", "coverage", "roadmap", "temporal",
                                     "conformal", "stl")} | {
        f"control/{m}.py" for m in ("trackers", "nonlinear", "cbf", "admm", "trajopt", "mpc",
                                    "cgmres", "rocket", "arm", "mppi", "mppi_variants",
                                    "mppi_value", "racing", "pusher_slider")} | {
        f"planning/{m}.py" for m in ("curves", "frenet", "reeds_shepp", "eta3", "rrt",
                                     "rrt_variants", "rrt_kinematic", "reactive", "hybrid_astar",
                                     "lattice", "chomp", "bipedal", "rigid_body", "branchout")} | {
        f"control/{m}.py" for m in ("aerial", "meta", "arena")} | {
        f"utils/{m}.py" for m in ("__init__", "bench_gate", "experiments", "profiling",
                                  "checkpoint", "roofline")} | {
        f"viz/{m}.py" for m in ("__init__", "raster")} | {
        f"experiments/{m}.py" for m in ("__init__", "path_tracking", "drone_quality",
                                        "ukf_ckf_accuracy", "point_cloud_sampling")} | {
        f"demos/{m}.py" for m in ("headless_family", "playground", "dataflow",
                                  "speed_comparison", "embedded_demo", "benchmarks",
                                  "scaling_report", "render", "gallery")} | {"native/__init__.py"}


def _string_constants(tree):
    """The string constants of a module but its docstrings."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree) if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs]


def test_port_reads_no_file_of_the_jax_package():
    """No module of the port names a path under rust_robotics_tpu/ in its
    code, and its own files sit in its own tree: the playground page is
    the port's copy, which its generator reads from beside itself."""
    for path in PORT_FILES[:-1]:
        for value in _string_constants(ast.parse(path.read_text(), filename=str(path))):
            parts = value.replace("\\", "/").split("/")
            assert "rust_robotics_tpu" not in parts, f"{path.relative_to(ROOT)}: {value!r}"
    assert _string_constants(ast.parse('"""doc"""\nx = "rust_robotics_tpu/demos"\n')) == [
        "rust_robotics_tpu/demos"]
    data = [p for p in (ROOT / "rust_robotics_tpu_torch").rglob("*")
            if p.is_file() and p.suffix in (".html", ".json", ".yaml", ".txt")]
    assert [p.relative_to(ROOT).as_posix() for p in data] == [
        "rust_robotics_tpu_torch/demos/playground_page.html"]
    for path in data:
        assert "rust_robotics_tpu/" not in path.read_text(), path
    from rust_robotics_tpu_torch.demos import playground

    src = ast.parse(pathlib.Path(playground.__file__).read_text())
    assert "playground_page.html" in _string_constants(src)
    assert "docs/playground" not in " ".join(_string_constants(src))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    import numpy as np

    from fixture_gen import make_euroc_fixture

    from rust_robotics_tpu_torch import convert
    from rust_robotics_tpu_torch.demos.ekf_localization import (
        default_ekf_noise,
        run_ekf_localization_demo,
    )
    from rust_robotics_tpu_torch.demos import pose_graph_bench
    from rust_robotics_tpu_torch.filters.extra import HistogramConfig, histogram_init
    from rust_robotics_tpu_torch.nlls import SolverConfig
    from rust_robotics_tpu_torch.nlls.tridiag import build_w_inv, nested_partition
    from rust_robotics_tpu_torch.planning import grid
    from rust_robotics_tpu_torch.slam.bundle_adjustment import CameraIntrinsics, bundle_adjust
    from rust_robotics_tpu_torch.nlls.implicit import pose_graph_implicit_vjp
    from rust_robotics_tpu_torch.slam.ekf_slam import init_ekf_slam
    from rust_robotics_tpu_torch.slam.fastslam import init_fastslam
    from rust_robotics_tpu_torch.slam.icp import icp_matching
    from rust_robotics_tpu_torch.slam.slam_node import run_slam_node_loop
    from rust_robotics_tpu_torch.slam.pose_graph import (
        optimize_pose_graph_2d,
        optimize_pose_graph_3d,
    )
    from rust_robotics_tpu_torch.data.euroc import EurocDataset
    from rust_robotics_tpu_torch.demos.headless import headless_euroc_vio
    from rust_robotics_tpu_torch.parallel.pipeline import Stage, run_pipelined
    from rust_robotics_tpu_torch.slam.vio import run_vio_pipeline
    from rust_robotics_tpu_torch.slam.vio_pp import make_stages, run_vio_pipeline_windowed
    from rust_robotics_tpu_torch.train import init_params, synthesize_batch
    from rust_robotics_tpu_torch.core.types import GridSpec2D
    from rust_robotics_tpu_torch.demos.headless import (
        headless_mission_recovery,
        headless_navigation_loop,
    )
    from rust_robotics_tpu_torch.mapping import gaussian_grid_map, lidar_to_grid
    from rust_robotics_tpu_torch.planning import jps_plan, octile_heuristic, plan_grid_3d
    from rust_robotics_tpu_torch.planning import (
        VisibilityPlanner,
        flow_field,
        potential_field,
        theta_wavefront_costs,
    )
    from rust_robotics_tpu_torch.planning.risk_graph import risk_wavefront_costs
    from rust_robotics_tpu_torch.planning.roadmap import build_prm, voronoi_roadmap
    from rust_robotics_tpu_torch.planning.stl import stl_cbs_plan
    from rust_robotics_tpu_torch.planning.temporal import time_expanded_costs
    from rust_robotics_tpu_torch.control import cgmres, mppi_value, pusher_slider, racing
    from rust_robotics_tpu_torch.control.rocket import RocketConfig, plan_landing
    from rust_robotics_tpu_torch.control.trackers import pid_reset
    from rust_robotics_tpu_torch.planning import frenet, hybrid_astar, rrt, rrt_kinematic
    from rust_robotics_tpu_torch.planning import rrt_variants
    from rust_robotics_tpu_torch.planning.curves import Spline2D
    from rust_robotics_tpu_torch.control import aerial, arena
    from rust_robotics_tpu_torch.planning import branchout, rigid_body
    from rust_robotics_tpu_torch.experiments import (
        drone_quality,
        path_tracking,
        point_cloud_sampling,
        ukf_ckf_accuracy,
    )

    blocked = np.eye(4, 3, dtype=bool)
    ox, oy = np.array([0.0, 4.0, 4.0]), np.array([0.0, 0.0, 3.0])
    states, weights = np.zeros((2, 8, 4)), np.full((2, 8), 1 / 8)
    # one camera (fixed) seeing two points; a two-pose chain
    cams, points = np.eye(4)[None], np.array([[0.0, 0.0, 5.0], [1.0, 0.0, 5.0]])
    cam_idx, pt_idx, pixels = np.zeros(2, np.int32), np.arange(2), np.array([[0.0, 0.0], [1.0, 0.0]])
    poses, ef, et, meas = np.zeros((2, 3)), np.array([0]), np.array([1]), np.ones((1, 3))
    poses6, meas6 = np.zeros((2, 6)), np.full((1, 6), 0.1)
    cloud = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
    make_euroc_fixture(str(tmp_path / "euroc"), duration=0.6)
    euroc = EurocDataset.load(str(tmp_path / "euroc"))
    tracks = euroc.load_feature_tracks()
    pre_fields = [np.eye(3), np.zeros(3), np.zeros(3), 0.1, np.zeros((9, 9)), np.zeros((9, 6)),
                  np.zeros(6)]
    window = {"accel": np.zeros((3, 2, 3)), "gyro": np.zeros((3, 2, 3)), "dts": np.zeros((3, 2)),
              "cam_local": np.zeros(4, np.int32), "pt_idx": np.zeros(4, np.int32),
              "pixels": np.zeros((4, 2)), "obs_mask": np.ones(4, bool)}
    host_data_calls = {
        "run_ekf_localization_demo": lambda **kw: run_ekf_localization_demo(steps=3, **kw)["estimate"],
        "default_ekf_noise": lambda **kw: default_ekf_noise(**kw)[0],
        "convert.to_tensor": lambda **kw: convert.to_tensor([1.0, 2.0], **kw),
        "convert.grid_from_numpy": lambda **kw: convert.grid_from_numpy(blocked, 0.0, 0.0, 1.0,
                                                                        **kw).blocked,
        "convert.particles_from_numpy": lambda **kw: convert.particles_from_numpy(
            states, weights, **kw).states,
        "grid_from_raster": lambda **kw: grid.grid_from_raster(blocked, **kw).blocked,
        "bundle_adjust": lambda **kw: bundle_adjust(
            cams, points, cam_idx, pt_idx, pixels, CameraIntrinsics(1.0, 1.0, 0.0, 0.0),
            config=SolverConfig(max_iterations=1), **kw)[1],
        "optimize_pose_graph_2d": lambda **kw: optimize_pose_graph_2d(
            poses, ef, et, meas, max_iterations=1, **kw)[0],
        **{f"optimize_pose_graph_2d {solver}": (
            lambda solver=solver, **kw: optimize_pose_graph_2d(
                poses, ef, et, meas, max_iterations=1, linear_solver=solver, **kw)[0])
           for solver in ("chain_direct", "banded_direct", "direct")},
        **{f"optimize_pose_graph_3d {solver}": (
            lambda solver=solver, **kw: optimize_pose_graph_3d(
                poses6, ef, et, meas6, max_iterations=1, linear_solver=solver, **kw)[0])
           for solver in ("dense", "chain_direct", "banded_direct")},
        "optimize_pose_graph_3d anchored": lambda **kw: optimize_pose_graph_3d(
            poses6, ef, et, meas6, max_iterations=1, linear_solver="chain_direct",
            anchored=True, anchor_rounds=0, **kw)[0],
        "pose_graph_implicit_vjp": lambda **kw: pose_graph_implicit_vjp(
            poses, ef, et, meas, None, lambda p: torch.sum(p[-1] ** 2), **kw)[1],
        "icp_matching": lambda **kw: icp_matching(cloud, cloud + 0.1, max_iter=2, **kw).transform,
        "nested_partition": lambda **kw: nested_partition(6, np.array([0]), np.array([3]),
                                                          **kw).bounds,
        "build_w_inv": lambda **kw: build_w_inv(None, 2, 3, torch.float32, **kw),
        "run_batched_benchmark": lambda **kw: pose_graph_bench.run_batched_benchmark(
            size=4, batch=2, max_iterations=1, **kw)[3],
        "convert.bundle_from_numpy": lambda **kw: convert.bundle_from_numpy(
            cams, points, cam_idx, pt_idx, pixels, **kw)[2],
        "convert.pose_graph_from_numpy": lambda **kw: convert.pose_graph_from_numpy(
            poses, ef, et, meas, **kw)[0],
        "grid_from_obstacle_points": lambda **kw: grid.grid_from_obstacle_points(
            ox, oy, 1.0, 0.5, **kw).blocked,
        "init_ekf_slam": lambda **kw: init_ekf_slam(2, **kw).cov,
        "init_fastslam": lambda **kw: init_fastslam(4, 2, **kw).lm_cov,
        "histogram_init": lambda **kw: histogram_init(HistogramConfig(width=4, height=3), **kw),
        "run_slam_node_loop": lambda **kw: run_slam_node_loop(steps=1, **kw)["corrected"],
        "convert.ekf_slam_from_numpy": lambda **kw: convert.ekf_slam_from_numpy(
            np.zeros(5), np.eye(5), 0, **kw).n_lm,
        "convert.fastslam_from_numpy": lambda **kw: convert.fastslam_from_numpy(
            np.zeros((4, 3)), np.full(4, 0.25), np.zeros((4, 2, 2)),
            np.tile(np.eye(2), (4, 2, 1, 1)), np.zeros((4, 2), bool), **kw).lm_seen,
        "convert.sqrt_belief_from_numpy": lambda **kw: convert.sqrt_belief_from_numpy(
            np.zeros(4), np.eye(4), **kw)[1],
        "run_vio_pipeline": lambda **kw: run_vio_pipeline(euroc, tracks, max_keyframes=3,
                                                          **kw).fused_poses,
        "run_vio_pipeline_windowed": lambda **kw: run_vio_pipeline_windowed(
            euroc, tracks, fuse_iterations=1, **kw).fused_poses,
        "make_stages": lambda **kw: make_stages(euroc, tracks, **kw)[2],
        "run_pipelined": lambda device=None: run_pipelined(
            [Stage(lambda x: x + 1)], [torch.zeros(2)],
            devices=None if device is None else [torch.device(device)])[0],
        "headless_euroc_vio": lambda **kw: torch.tensor(headless_euroc_vio(
            tmpdir=str(tmp_path / "headless"), **kw)["fused_position_rmse"]),
        "convert.preintegrated_from_numpy": lambda **kw: convert.preintegrated_from_numpy(
            type("Pre", (), dict(zip(("delta_rotation", "delta_position", "delta_velocity",
                                      "delta_time", "covariance", "bias_jacobian", "lin_bias"),
                                     pre_fields))), **kw).covariance,
        "convert.nav_from_numpy": lambda **kw: convert.nav_from_numpy(
            np.zeros((2, 9)), np.zeros((2, 6)), **kw)[0],
        "convert.vio_window_from_numpy": lambda **kw: convert.vio_window_from_numpy(
            window, **kw)["obs_mask"],
        "init_params": lambda **kw: init_params(**kw).log_q,
        "synthesize_batch": lambda **kw: synthesize_batch(0, batch=2, steps=2, num_landmarks=2,
                                                          **kw)[2],
        "headless_navigation_loop": lambda **kw: torch.tensor(headless_navigation_loop(
            steps=2, **kw)["path_length"]),
        "headless_mission_recovery": lambda **kw: torch.tensor(headless_mission_recovery(
            max_steps=2, **kw)["final_distance"]),
        "gaussian_grid_map": lambda **kw: gaussian_grid_map(ox, oy, 1.0, 0.5, extend=1.0,
                                                            **kw)[0],
        "lidar_to_grid": lambda **kw: lidar_to_grid(
            np.zeros(2), np.array([0.0, 1.0]), np.array([1.0, 2.0]),
            GridSpec2D(-3.0, -3.0, 0.5, 12, 12), samples=8, **kw),
        "jps_plan": lambda **kw: torch.tensor(jps_plan(~blocked, (0, 1), (3, 2), **kw)["cost"]),
        "plan_grid_3d": lambda **kw: plan_grid_3d(np.ones((3, 3, 3), bool), (0, 0, 0), (2, 2, 2),
                                                  max_len=4, **kw)[0],
        "octile_heuristic": lambda **kw: octile_heuristic((4, 3), (1, 1), **kw),
        "flow_field": lambda **kw: flow_field(~blocked, blocked, **kw),
        "potential_field": lambda **kw: potential_field(~blocked, (1, 1), **kw),
        "theta_wavefront_costs": lambda **kw: theta_wavefront_costs(~blocked, (3, 2), iters=4,
                                                                    samples=8, **kw)[0],
        "VisibilityPlanner": lambda **kw: VisibilityPlanner(~blocked, **kw).vis,
        "risk_wavefront_costs": lambda **kw: risk_wavefront_costs(~blocked, np.ones((4, 3)),
                                                                  blocked, **kw),
        "time_expanded_costs": lambda **kw: time_expanded_costs(np.ones((3, 4, 3), bool), (0, 0),
                                                                **kw),
        "build_prm": lambda **kw: build_prm(None, [0.5, 0.5], [9.0, 9.0], np.stack([ox, oy], -1),
                                            np.ones(3), num_samples=4, **kw)[1],
        "voronoi_roadmap": lambda **kw: voronoi_roadmap([0.5, 0.5], [3.5, 2.5], blocked, 0.0, 0.0,
                                                        1.0, max_vertices=4, **kw)[1],
        "stl_cbs_plan": lambda **kw: torch.tensor(stl_cbs_plan(~blocked, [(0, 1)], [(3, 2)], 6,
                                                               **kw)["total_cost"]),
    }
    quad = racing.MotorQuadParams()
    gate = racing.GatePlane((3.0, 0.0, 1.5), (0.0, 1.0, 0.0))
    pusher, push_cfg = pusher_slider.PusherSliderParams(), pusher_slider.PusherMppiConfig(
        horizon=2, num_samples=4)
    host_data_calls.update({
        "pid_reset": lambda **kw: pid_reset((2,), **kw)[0],
        "make_track": lambda **kw: mppi_value.make_track([[0.0, 0.0], [1.0, 0.0]],
                                                         **kw).cumulative_lengths,
        "grid_from_goal_distance": lambda **kw: mppi_value.grid_from_goal_distance(
            3, 2, (0.0, 0.0), 1.0, (1.0, 1.0), **kw).values,
        "make_replay_buffer": lambda **kw: mppi_value.make_replay_buffer(2, 3, 4, **kw).states,
        "hover_state": lambda **kw: racing.hover_state(0.0, 0.0, 1.0, quad, **kw),
        "powertrain_init": lambda **kw: racing.powertrain_init(
            racing.hover_state(0.0, 0.0, 1.0, quad, **kw), racing.PowertrainParams()),
        "make_gate_lap_costs": lambda **kw: racing.make_gate_lap_costs([gate], **kw)[1](
            racing.hover_state(0.0, 0.0, 1.0, quad, **kw)),
        "simulate_gate_race": lambda **kw: torch.tensor(racing.simulate_gate_race(
            None, [gate], racing.PowertrainParams(), steps=1, horizon=2, num_samples=4,
            **kw)["final_soc"]),
        "simulate_push": lambda **kw: torch.tensor(pusher_slider.simulate_push(
            None, pusher, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), steps=1, cfg=push_cfg,
            **kw)["final_position_error"]),
        "pusher_mppi_plan": lambda **kw: pusher_slider.pusher_mppi_plan(
            None, pusher, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), push_cfg, **kw)[2],
        "two_contact_twist": lambda **kw: pusher_slider.two_contact_twist(
            pusher, (0, 2), (0.0, 0.0), (0.05, 0.05), (0.5, 0.5), **kw)[0],
        "plan_landing": lambda **kw: plan_landing([0.0, 5.0, 0.0, 0.0], [0.0, 0.0], RocketConfig(
            horizon=2, outer_iterations=1, inner_iterations=1), **kw)[1],
        "rrt_plan": lambda **kw: rrt.rrt_plan(None, [0.0, 0.0], [1.0, 1.0], [[5.0, 5.0]], [0.5],
                                              rrt.RRTConfig(max_nodes=3), star=True, **kw)[2],
        "rrt_connect_plan": lambda **kw: rrt_variants.rrt_connect_plan(
            None, [0.0, 0.0], [1.0, 1.0], [[5.0, 5.0]], [0.5], rrt.RRTConfig(max_nodes=3),
            **kw)[2],
        "rrt_star_dubins_plan": lambda **kw: rrt_kinematic.rrt_star_dubins_plan(
            None, [0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [[5.0, 5.0]], [0.5],
            rrt_kinematic.KinematicRRTConfig(max_nodes=3), **kw)[2],
        "hybrid_astar_costs": lambda **kw: hybrid_astar.hybrid_astar_costs(
            np.ones((4, 4), bool), (1, 1), 0, n_theta=4, **kw),
        "frenet_optimal_plan": lambda **kw: frenet.frenet_optimal_plan(
            Spline2D.fit([0.0, 10.0, 20.0, 30.0], [0.0, 1.0, 0.0, 1.0], **kw), 0.0, 1.0, 0.0, 0.0,
            0.0, np.array([[50.0, 50.0]]), frenet.FrenetConfig(max_road_width=1.0))["path"],
        "run_cgmres": lambda **kw: cgmres.run_cgmres(
            lambda x, u: torch.stack([x[1], u[0] - x[0]]), lambda x, u: torch.sum(x * x) + u[0] ** 2,
            lambda x: torch.sum(x * x), [1.0, 0.0], 1, cgmres.CGMRESConfig(horizon=2), **kw)[0],
    })
    cell = point_cloud_sampling.CloudCase("c", (8,), base_point_count=16)
    nominal = ukf_ckf_accuracy.SCENARIO_FAMILIES["nominal"]
    host_data_calls.update({
        "quintic_3d_segments": lambda **kw: aerial.quintic_3d_segments(points, 2.0, **kw),
        "minimum_snap_coeffs": lambda **kw: aerial.minimum_snap_coeffs([0.0, 1.0, 0.5],
                                                                       [1.0, 1.0], **kw),
        "run_controller_arena": lambda **kw: torch.tensor(arena.run_controller_arena(
            steps=2, **kw)[0]["stanley"]["progress"]),
        "aabb_obstacle": lambda **kw: rigid_body.aabb_obstacle(0.0, 1.0, 0.0, 1.0, **kw),
        "branchout_plan": lambda **kw: branchout.branchout_plan(branchout.BranchOutScene(),
                                                                **kw)["cost"],
        "simulate_closed_loop": lambda **kw: torch.tensor(branchout.simulate_closed_loop(
            branchout.BranchOutScene(), [(0.0, 0.0)], steps=1, **kw)["min_clearance"]),
        "discrete_frechet": lambda **kw: branchout.discrete_frechet(cloud, cloud, **kw),
        "time_to_collision": lambda **kw: branchout.time_to_collision(
            (0.0, 0.0), (1.0, 0.0), (3.0, 0.0), (0.0, 0.0), 1.0, **kw),
        "run_path_tracking_accuracy": lambda **kw: torch.tensor(
            path_tracking.run_path_tracking_accuracy(seeds=(0,), steps=2, **kw)[0].summary[
                "goal_rate"]),
        "run_drone_trajectory_quality": lambda **kw: torch.tensor(
            drone_quality.run_drone_trajectory_quality(seeds=(0,), **kw)[0].summary[
                "mean_jerk"]),
        "simulate_family_rmse": lambda **kw: ukf_ckf_accuracy.simulate_family_rmse(
            nominal, 2, 2, **kw)[0],
        "run_ukf_ckf_accuracy": lambda **kw: torch.tensor(ukf_ckf_accuracy.run_ukf_ckf_accuracy(
            families={"nominal": nominal}, steps=2, n_scenarios=2, buckets=(2,), **kw)[
                "head_8"][0].ukf_min_rmse),
        "slot_scores_for_cell": lambda **kw: point_cloud_sampling.slot_scores_for_cell(
            cell, 8, 2, max_iter=4, **kw),
        "run_point_cloud_sampling_quality": lambda **kw: torch.tensor(
            point_cloud_sampling.run_point_cloud_sampling_quality(
                problems={"p": [cell]}, scenarios_per_bucket=2, max_iter=4, **kw)[
                "full-bucket"]["average_coverage_ratio"]),
        "run_batched_compaction_benchmark": lambda **kw: torch.tensor(
            pose_graph_bench.run_batched_compaction_benchmark(size=4, batch=2, chunk_iters=1,
                                                              max_rounds=1, **kw)[1]),
    })
    for name, call in host_data_calls.items():
        if torch.cuda.is_available():
            assert call().is_cuda, name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert call(device="cpu").device.type == "cpu", name


def test_demo_family_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """The headless family, the playground, dataflow and the speed
    comparison make their tensors on the card unless given device="cpu";
    without a card they raise."""
    from rust_robotics_tpu_torch.demos import dataflow, headless_family, playground
    from rust_robotics_tpu_torch.demos import speed_comparison

    calls = {
        "headless_conformal_sipp": lambda **kw: headless_family.headless_conformal_sipp(**kw),
        "headless_mppi_double_integrator": lambda **kw: (
            headless_family.headless_mppi_double_integrator(1, **kw)),
        "run_headless": lambda **kw: headless_family.run_headless(
            "headless_rigid_body_mip_planning", **kw),
        "arena_rollouts": lambda **kw: playground.arena_rollouts("stanley", steps=1, **kw),
        "main": lambda **kw: playground.main(str(tmp_path / "site"), **kw),
        "run_path_planning_dataflow": lambda **kw: dataflow.run_path_planning_dataflow(1, **kw),
        "build_ekf_dataflow": lambda **kw: dataflow.build_ekf_dataflow(**kw)[0].run(1),
        "speed_workloads": lambda **kw: speed_comparison.speed_workloads(2, **kw)[
            "cubic_spline"][0](),
    }
    for name, call in calls.items():
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    # on the CPU when asked (main's tabs are held in test_torch_playground_dataflow.py)
    for name, call in calls.items():
        if name != "main":
            assert call(device="cpu") is not None, name


def test_distributed_entry_points_need_nccl_unless_asked_for_the_cpu():
    """The mesh runs NCCL on the card by default and never falls back to
    gloo: without a card (or NCCL) the default raises; device_type="cpu"
    gives a gloo mesh."""
    import torch.distributed as dist

    from rust_robotics_tpu_torch.parallel import mesh as pmesh
    from rust_robotics_tpu_torch.parallel.sharded_nlls import solve_sharded

    if torch.cuda.is_available() and dist.is_nccl_available():
        pytest.skip("a card with NCCL is present")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pmesh.init_process_group()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(ValueError, match="needs a mesh"):
        solve_sharded(None)
    pmesh.init_process_group(device_type="cpu")
    try:
        mesh = pmesh.make_mesh(device_type="cpu")
        assert dist.get_backend() == "gloo" and tuple(mesh.shape) == (1, 1)
        assert pmesh.mesh_device(mesh).type == "cpu"
    finally:
        dist.destroy_process_group()


def test_slice_14_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """The pinned registry, every render, the gallery and the scaling
    report run on the card by default: without one they raise; with
    device="cpu" (device_type="cpu") they run. `run_all` and `gallery.main`
    have no default output directory."""
    import inspect

    from rust_robotics_tpu_torch.demos import benchmarks, gallery, render, scaling_report

    assets = str(ROOT / "docs" / "assets")
    calls = {
        "run_benchmark": lambda **kw: benchmarks.run_benchmark("racing-motor-benchmark", **kw),
        "check_gate": lambda **kw: benchmarks.check_gate(
            assets, names=["racing-motor-benchmark"], **kw),
        "build_gallery": lambda **kw: gallery.build_gallery(
            str(tmp_path / "g"), names=["render_svg_dubins"], **kw),
        **{name: lambda name=name, **kw: render.RENDERS[name](str(tmp_path / name), **kw)
           for name in render.RENDERS},
    }
    if not torch.cuda.is_available():
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        for call in (scaling_report.run_scaling_report, scaling_report.run_chain_weak_scaling):
            with pytest.raises(RuntimeError, match="device_type='cpu'"):
                call((1,))
    header, rows = calls["run_benchmark"](device="cpu")
    assert header[0] == "steps" and rows[0][0] == "100"
    assert calls["check_gate"](device="cpu") == (True, [])
    assert calls["render_svg_dubins"](device="cpu") is not None
    for fn, arg in ((benchmarks.run_all, "outdir"), (gallery.main, "outdir")):
        assert inspect.signature(fn).parameters[arg].default is inspect.Parameter.empty
