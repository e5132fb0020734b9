"""The headless demos that draw outside the MPPI loop
(`demos/headless_family.py`: the factor-graph stack, the localizer, gate
racing) against the JAX package's: JAX on the CPU at x64, torch in
float64 on the CPU.

The factor-graph stack runs at its full size in both packages (its ICP
clouds JAX's draws) and passes tests/test_headless_family.py's gate. The
localizer runs 4 steps and gate racing 3 in both packages on JAX's draws:
the port takes the normals and uniforms JAX draws from its keys
(`draws=`), split as the JAX demos split them. JAX's filter steps, MPPI
plan and powertrain are jitted inside its loops. Output dicts equal
JAX's: booleans, integers and strings exactly, floats within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rust_robotics_tpu.control import mppi as jm
from rust_robotics_tpu.control import racing as jr
from rust_robotics_tpu.demos import headless_family as jf
from rust_robotics_tpu.filters import kalman as jk
from rust_robotics_tpu.filters import particle as jp
from rust_robotics_tpu_torch.demos import headless_family as tf
from test_headless_family import EXPECT
from test_torch_headless_family import CPU, same

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def normals(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


def test_factor_graph_stack_matches_jax_and_passes_its_gate():
    key = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(key)
    draws = (np.asarray(jax.random.uniform(k1, (160, 3), jnp.float64, -2.0, 2.0)),
             np.asarray(jax.random.normal(k2, (160, 3), jnp.float64)))
    got = tf.headless_factor_graph_stack(draws=draws, **CPU)
    same(got, jf.headless_factor_graph_stack())
    EXPECT["headless_factor_graph_stack"](got)


def test_localizers_match_jax_for_four_steps(monkeypatch):
    # JAX's loop calls the filter steps from the host; here their jitted selves
    for name in ("ekf_step", "ukf_step", "ckf_step"):
        monkeypatch.setattr(jk, name, jax.jit(getattr(jk, name)))
    monkeypatch.setattr(jp, "pf_step", jax.jit(jp.pf_step, static_argnames=("method",)))
    steps = 4
    init = normals(jax.random.PRNGKey(0), (512, 4))
    key, pred, unif = jax.random.PRNGKey(1), [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_pred, k_res = jax.random.split(sub)
        pred.append(normals(k_pred, (512, 2)))
        unif.append(np.asarray(jax.random.uniform(k_res, (1,), jnp.float64)))
    got = tf.headless_localizers(steps, draws=(init, np.stack(pred), np.stack(unif)), **CPU)
    same(got, jf.headless_localizers(steps))


def test_racing_gate_progress_matches_jax_for_three_steps(monkeypatch):
    # JAX's race calls `mppi_plan` and the powertrain from the host each
    # step; here their jitted selves
    monkeypatch.setattr(jr, "mppi_plan", jax.jit(jm.mppi_plan, static_argnums=(1, 2, 3, 6)))
    monkeypatch.setattr(jr, "powertrain_step", jax.jit(jr.powertrain_step, static_argnums=(0, 3)))
    steps = 3
    key = jax.random.PRNGKey(0)
    draws = np.stack([normals(k, (128, 15, 4)) for k in jax.random.split(key, steps)])
    got = tf.headless_mppi_racing_gate_progress(steps, draws=draws, **CPU)
    # the JAX demo runs 90 steps; its race at 3, summarised as the demo does
    gates = [jr.GatePlane(center=(x, 0.0, 1.5), normal=(1.0, 0.0, 0.0), half_width=1.2,
                          half_height=1.2) for x in (3.0, 6.0)]
    p = jr.PowertrainParams(motor_tau=0.05, discharge_rate=0.05, sag_coeff=0.15)
    rep = jr.simulate_gate_race(key, gates, p, steps=steps, num_samples=128, horizon=15,
                                aware=True)
    same(got, {"gates_passed": int(rep["gates_passed"]),
               "lap_fraction": float(rep["lap_fraction"]),
               "mean_speed": float(rep["mean_speed"]),
               "saturation_fraction": float(rep["saturation_fraction"]),
               "final_soc": float(rep["final_soc"])})
