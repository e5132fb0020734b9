"""The headless demo family (`demos/headless_family.py`) against the JAX
package's: JAX on the CPU at x64, torch in float64 on the CPU.

Each demo of tests/test_headless_family.py's FAST list runs once in each
package at its full size (the JAX run shared through `functools.lru_cache`),
and the port's output dict must equal JAX's: booleans, integers and strings
exactly, floats within 1e-9. The port's outputs also pass that file's
EXPECT gates. The factor-graph stack (JAX's ~16 s) is held in
tests/test_torch_headless_draws.py with the demos that draw, so that each
file stays near 30 s serial. A float32 run of the port is held to JAX's
float64 at 1e-4 relative.
"""

import functools

import numpy as np
import pytest
import torch

from rust_robotics_tpu.demos import headless_family as jf
from rust_robotics_tpu_torch.demos import headless as th
from rust_robotics_tpu_torch.demos import headless_family as tf
from test_headless_family import EXPECT, FAST

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-9
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def same(got, want, atol=ATOL, rtol=0.0):
    """Dicts with the same keys; discrete values equal, floats close."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (bool, np.bool_, str, int, np.integer)) and not isinstance(w, float):
            assert g == w and type(g) is type(w), (k, g, w)
        else:
            assert isinstance(g, float), (k, g)
            np.testing.assert_allclose(g, float(w), atol=atol, rtol=rtol, err_msg=k)


@functools.lru_cache(maxsize=None)
def jax_fast(name):
    return jf.HEADLESS[name]()


@functools.lru_cache(maxsize=None)
def port_fast(name):
    return tf.HEADLESS[name](**CPU)


# the factor-graph stack is tests/test_torch_headless_draws.py's
PLANNERS = [n for n in FAST if n != "headless_factor_graph_stack"]


@pytest.mark.parametrize("name", PLANNERS)
def test_fast_demo_matches_jax_and_passes_its_gate(name):
    got = port_fast(name)
    same(got, jax_fast(name))
    EXPECT[name](got)


def test_grid_planners_float32_within_tolerance():
    got = tf.headless_grid_planners(device="cpu", dtype=torch.float32)
    want = jax_fast("headless_grid_planners")
    for k, w in want.items():
        if isinstance(w, bool):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)


def test_registry_has_23_demos_and_run_headless_reaches_26():
    assert len(tf.HEADLESS) == 23
    assert list(tf.HEADLESS) == list(jf.HEADLESS)
    existing = tf._existing()
    assert set(existing) == set(jf._existing())
    assert existing["headless_navigation_loop"] is th.headless_navigation_loop
    assert existing["headless_mission_recovery"] is th.headless_mission_recovery
    assert existing["headless_euroc_vio"] is th.headless_euroc_vio
    # run_headless resolves both tables and passes its arguments on
    out = tf.run_headless("headless_conformal_sipp", **CPU)
    assert out == port_fast("headless_conformal_sipp")
    out = tf.run_headless("headless_navigation_loop", steps=3, **CPU)
    assert out["steps_used"] == 3
