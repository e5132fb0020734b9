"""The MPPI family of the headless demos (`demos/headless_family.py`)
against the JAX package's: JAX on the CPU at x64, torch in float64 on the
CPU.

Each demo runs 3 steps in both packages on JAX's draws: the port takes
the normals JAX draws from its keys (`draws=`), split as the JAX demos
split them. JAX's `mppi_plan` is jitted inside its loops, as
tests/test_torch_mppi.py does, but where a demo makes a new cost or
config every step (a compile a step). Output dicts equal JAX's: booleans,
integers and strings exactly, floats within 1e-9; a float32 run of the
port is held at 1e-4 relative. The demos that draw outside the MPPI loop
are tests/test_torch_headless_draws.py's; the last four of the family
(adaptive temperature, constraint discount, track progress, ADAP-RPF) are
tests/test_torch_headless_mppi_variants.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.control import mppi as jm
from rust_robotics_tpu.demos import headless_family as jf
from rust_robotics_tpu_torch.demos import headless_family as tf
from test_torch_headless_family import CPU, same

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def normals(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


def loop_draws(seed, steps, shape):
    """The normals `_mppi_loop` draws from PRNGKey(seed), step by step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(normals(sub, shape))
    return np.stack(out)


def jit_mppi(monkeypatch):
    monkeypatch.setattr(jm, "mppi_plan", jax.jit(jm.mppi_plan, static_argnums=(1, 2, 3, 6)))


MPPI = [
    # (name, JAX kwargs, the port's draws)
    ("headless_mppi_double_integrator", dict(steps=3), lambda: loop_draws(0, 3, (256, 25, 2))),
    ("headless_mppi_terminal_value", dict(steps=3), lambda: loop_draws(7, 3, (512, 25, 2))),
    ("headless_mppi_value_learning", dict(episodes=2, steps=3),
     lambda: np.stack([loop_draws(e, 3, (256, 24, 2)) for e in range(2)])),
    ("headless_mppi_replay_value_learning", dict(episodes=2, steps=3),
     lambda: np.stack([loop_draws(10 + e, 3, (256, 22, 2)) for e in range(2)])),
    ("headless_mppi_adaptive_temperature", dict(steps=3), lambda: loop_draws(3, 3, (256, 25, 2))),
    ("headless_mppi_constraint_discount", dict(steps=3), lambda: loop_draws(0, 3, (320, 28, 2))),
    ("headless_mppi_track_progress", dict(steps=3), lambda: loop_draws(0, 3, (320, 25, 2))),
    ("headless_adap_rpf_mppi", dict(steps=3), lambda: loop_draws(5, 3, (360, 16, 2))),
]


# JAX's `mppi_plan` runs eagerly where a demo makes a new cost or config
# every step (jitted, it would compile every step)
EAGER = ("headless_mppi_adaptive_temperature", "headless_adap_rpf_mppi")


def check_mppi_demo(monkeypatch, name, kw, draws):
    if name not in EAGER:
        jit_mppi(monkeypatch)
    got = tf.HEADLESS[name](draws=draws(), **kw, **CPU)
    same(got, jf.HEADLESS[name](**kw))


# the first four here, the others in tests/test_torch_headless_mppi_variants.py
@pytest.mark.parametrize("name,kw,draws", MPPI[:4], ids=[m[0] for m in MPPI[:4]])
def test_mppi_demo_matches_jax_for_three_steps(monkeypatch, name, kw, draws):
    check_mppi_demo(monkeypatch, name, kw, draws)


def test_mppi_double_integrator_float32_within_tolerance(monkeypatch):
    jit_mppi(monkeypatch)
    draws = loop_draws(0, 3, (256, 25, 2))
    got = tf.headless_mppi_double_integrator(3, device="cpu", dtype=torch.float32, draws=draws)
    want = jf.headless_mppi_double_integrator(3)
    for k in ("final_distance", "mean_ess"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["goal_reached"] == want["goal_reached"]
