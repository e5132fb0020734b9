"""Locate the reference's checked-in mini dataset fixtures.

The port's own copy of rust_robotics_tpu/data/fixtures.py. The reference
pins tiny EuRoC/KITTI layouts under
crates/rust_robotics_slam/tests/fixtures/{euroc_mini,kitti_mini} and runs
its CI VIO replay against them (headless_euroc_vio.rs:18-20). A checkout of
the reference is found only where the environment variable
RUST_ROBOTICS_REFERENCE names it (the JAX package also looks in a default
place outside the repository; the port reads nothing outside it unasked).
Without one, callers fall back to the synthetic generators in
tests/fixture_gen.py.
"""

from __future__ import annotations

import os


def _reference_root():
    return os.environ.get("RUST_ROBOTICS_REFERENCE")


def _existing_dir(*parts):
    root = _reference_root()
    if not root:
        return None
    path = os.path.join(root, *parts)
    return path if os.path.isdir(path) else None


def reference_fixture_root(name: str):
    """Absolute path to the reference fixture `name` ('euroc_mini' or
    'kitti_mini'), or None when the reference checkout is unavailable."""
    return _existing_dir("crates", "rust_robotics_slam", "tests", "fixtures", name)


def reference_benchdata_root():
    """Path to the reference's MovingAI benchmark maps
    (crates/rust_robotics_planning/benchdata/moving_ai), or None."""
    return _existing_dir("crates", "rust_robotics_planning", "benchdata", "moving_ai")


def reference_testdata_root():
    """Path to the reference's planning golden CSVs
    (crates/rust_robotics_planning/src/testdata), or None."""
    return _existing_dir("crates", "rust_robotics_planning", "src", "testdata")
