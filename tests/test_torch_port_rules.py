"""Rules the port keeps: it imports neither JAX nor the JAX package (it
keeps its own copy of what it needs), triton only inside the function that
launches a kernel, and its entry points never fall back to the CPU
unasked."""

import ast
import pathlib

import pytest
import torch

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


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import numpy as np

    from rust_robotics_tpu_torch import convert
    from rust_robotics_tpu_torch.demos.ekf_localization import (
        default_ekf_noise,
        run_ekf_localization_demo,
    )
    from rust_robotics_tpu_torch.demos import pose_graph_bench
    from rust_robotics_tpu_torch.nlls import SolverConfig
    from rust_robotics_tpu_torch.nlls.tridiag import build_w_inv, nested_partition
    from rust_robotics_tpu_torch.planning import grid
    from rust_robotics_tpu_torch.slam.bundle_adjustment import CameraIntrinsics, bundle_adjust
    from rust_robotics_tpu_torch.slam.pose_graph import optimize_pose_graph_2d

    blocked = np.eye(4, 3, dtype=bool)
    ox, oy = np.array([0.0, 4.0, 4.0]), np.array([0.0, 0.0, 3.0])
    states, weights = np.zeros((2, 8, 4)), np.full((2, 8), 1 / 8)
    # one camera (fixed) seeing two points; a two-pose chain
    cams, points = np.eye(4)[None], np.array([[0.0, 0.0, 5.0], [1.0, 0.0, 5.0]])
    cam_idx, pt_idx, pixels = np.zeros(2, np.int32), np.arange(2), np.array([[0.0, 0.0], [1.0, 0.0]])
    poses, ef, et, meas = np.zeros((2, 3)), np.array([0]), np.array([1]), np.ones((1, 3))
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
    }
    for name, call in host_data_calls.items():
        if torch.cuda.is_available():
            assert call().is_cuda, name
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert call(device="cpu").device.type == "cpu", name
