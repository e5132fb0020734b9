"""The port's sharded particle filters (rust_robotics_tpu_torch/parallel/
sharded_filters.py) against JAX's (rust_robotics_tpu/parallel/
sharded_filters.py), and `pf_predict(noise=)`.

The SPMD programs run on 2 and 4 gloo ranks over a flat 'data' mesh,
spawned once per mesh size (tests/torch_dist_workers.py), fed the draws
JAX makes from its keys (`draws=`). Each must equal the port's one-process
function bitwise (`pf_bank_step` on the whole batch, `fastslam_oracle_step`
on the whole filter), in f64 and f32, and JAX's same program on a mesh of
the same size of conftest's virtual CPU devices within 1e-10 in f64. There
is no f32 comparison with JAX: in f32 a resample position may fall on the
other side of a CDF boundary, and a flipped parent moves a state by the
cloud's spread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_workers as workers
from rust_robotics_tpu.filters.particle import ParticleBelief as JaxBelief
from rust_robotics_tpu.filters.particle import init_particles
from rust_robotics_tpu.parallel.sharded_filters import (
    make_fastslam_sharded_step as jax_fastslam_step,
    make_pf_banks_step as jax_pf_banks_step,
)
from rust_robotics_tpu.slam.fastslam import FastSLAMParticles as JaxParticles
from rust_robotics_tpu.slam.fastslam import init_fastslam
from rust_robotics_tpu_torch.filters import particle as tpf
from rust_robotics_tpu_torch.filters.particle import ParticleBelief

WORLDS = (2, 4)
TOL = 1e-10
PF_STEPS = 3
FS_STEPS = 3


def _pf_inputs(b=16, p=256):
    """tests/test_sharded.py's bank setup, with JAX's per-bank draws of
    PF_STEPS steps: (noise [B, P, 2], uniform [B, 1])."""
    landmarks = jnp.asarray([[5.0, 0.0], [0.0, 5.0], [-5.0, 2.0], [3.0, -4.0]])
    kinit, kstep = jax.random.split(jax.random.PRNGKey(11))
    mean = jnp.tile(jnp.asarray([0.0, 0.0, 0.3, 1.0]), (b, 1))
    belief = init_particles(kinit, mean, 0.5, p)
    keys = [jax.random.split(k, b) for k in jax.random.split(kstep, PF_STEPS)]

    def bank_draws(key):
        k_pred, k_res = jax.random.split(key)
        return (jax.random.normal(k_pred, (p, 2), jnp.float64),
                jax.random.uniform(k_res, (1,), jnp.float64))

    draws = [tuple(np.asarray(a) for a in jax.vmap(bank_draws)(k)) for k in keys]
    return {"states": np.asarray(belief.states), "weights": np.asarray(belief.weights),
            "controls": np.tile([1.0, 0.1], (b, 1)),
            "ranges": np.linalg.norm(np.asarray(mean)[:, None, :2] - np.asarray(landmarks)[None],
                                     axis=-1),
            "landmarks": np.asarray(landmarks), "cns": np.array([0.2, 0.05]), "dt": 0.1,
            "range_noise": 0.5, "draws": draws, "keys": keys}


def _fs_draws(p, seeds):
    """JAX's sharded FastSLAM draws: per-slot fold_in normals and the
    shared resample uniform, per step."""
    out = []
    for seed in seeds:
        k_pred, k_res = jax.random.split(jax.random.PRNGKey(seed))
        keys = jax.vmap(jax.random.fold_in, (None, 0))(k_pred, jnp.arange(p))
        noise = jax.vmap(lambda k: jax.random.normal(k, (2,), jnp.float64))(keys)
        uniform = np.asarray(jax.random.uniform(k_res, (), jnp.float64))[None]
        out.append((np.asarray(noise), uniform))
    return out


def _fs_inputs(p=64, nl=6, seed=5, sharp=False):
    """tests/test_sharded.py's FastSLAM setup (`sharp`: the resample-trigger
    case, one heavy particle and no observation)."""
    rng = np.random.default_rng(seed)
    landmarks = rng.uniform(-8, 8, (nl, 2))
    parts = init_fastslam(p, nl)
    weights = np.asarray(parts.weights)
    if sharp:
        weights = np.full((p,), 1e-6)
        weights[3] = 1.0
        weights = weights / weights.sum()
    obs = [[np.linalg.norm(lm), np.arctan2(lm[1], lm[0]), i] for i, lm in enumerate(landmarks)]
    return {"poses": np.asarray(parts.poses), "weights": weights,
            "lm_mean": np.asarray(parts.lm_mean), "lm_cov": np.asarray(parts.lm_cov),
            "lm_seen": np.asarray(parts.lm_seen), "chol": np.diag([0.15, 0.05]),
            "r_obs": np.diag([0.1, 0.02]), "obs": np.asarray(obs),
            "mask": np.full((nl,), not sharp), "u": np.array([1.0, 0.1]), "dt": 0.1,
            "seeds": [0] if sharp else [100 + t for t in range(FS_STEPS)],
            "draws": _fs_draws(p, [0] if sharp else [100 + t for t in range(FS_STEPS)])}


PF = _pf_inputs()
FS = _fs_inputs()
SHARP = _fs_inputs(p=32, sharp=True)


def _for_workers(d):
    return {k: v for k, v in d.items() if k not in ("keys", "seeds")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: workers.run_spmd(workers.filters_program, w, tmp_path_factory.mktemp("filt"),
                                _for_workers(PF), _for_workers(FS), _for_workers(SHARP))
            for w in WORLDS}


@functools.lru_cache(maxsize=None)
def _jax_pf(world):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    step = jax_pf_banks_step(mesh, PF["dt"], jnp.asarray(PF["cns"]), PF["range_noise"])
    belief = JaxBelief(jnp.asarray(PF["states"]), jnp.asarray(PF["weights"]))
    for keys in PF["keys"]:
        belief, est = step(belief, jnp.asarray(PF["controls"]), jnp.asarray(PF["ranges"]),
                           jnp.asarray(PF["landmarks"]), keys)
    return (np.asarray(belief.states), np.asarray(belief.weights), np.asarray(est.mean),
            np.asarray(est.cov))


@functools.lru_cache(maxsize=None)
def _jax_fs(world, case):
    inputs = FS if case == "fs" else SHARP
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    step = jax_fastslam_step(mesh, inputs["dt"], jnp.asarray(inputs["chol"]),
                             jnp.asarray(inputs["r_obs"]))
    parts = JaxParticles(*(jnp.asarray(inputs[k]) for k in
                           ("poses", "weights", "lm_mean", "lm_cov", "lm_seen")))
    for seed in inputs["seeds"]:
        parts = step(parts, jnp.asarray(inputs["u"]), jnp.asarray(inputs["obs"]),
                     jnp.asarray(inputs["mask"]), jax.random.key_data(jax.random.PRNGKey(seed)),
                     jnp.asarray(0, jnp.int32))
    return {k: np.asarray(getattr(parts, k)) for k in
            ("poses", "weights", "lm_mean", "lm_cov", "lm_seen")}


@pytest.mark.parametrize("world", WORLDS)
def test_pf_banks_equal_one_process_bitwise_and_jax(runs, world):
    want = _jax_pf(world)
    for out in runs[world]:
        for name in ("f64", "f32"):
            got = out[f"pf_{name}"]
            states, weights, mean, cov = got["oracle"]
            for key, oracle in (("states", states), ("weights", weights), ("mean", mean),
                                ("cov", cov)):
                assert torch.equal(got[key], oracle), (name, key)
        got = out["pf_f64"]
        for key, w in zip(("states", "weights", "mean", "cov"), want):
            np.testing.assert_allclose(got[key].numpy(), w, rtol=TOL, atol=TOL, err_msg=key)
        # the generator route draws the global arrays alike on every layout
        first = runs[WORLDS[0]][0]["pf_f64"]
        assert torch.equal(got["generator_states"], first["generator_states"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ("fs", "sharp"))
def test_fastslam_sharded_equals_oracle_bitwise_and_jax(runs, world, case):
    want = _jax_fs(world, case)
    for out in runs[world]:
        got = out[case]
        for key in ("poses", "weights", "lm_mean", "lm_cov", "lm_seen"):
            assert torch.equal(got[key], got["oracle"][key]), key
            np.testing.assert_allclose(got[key].numpy().astype(np.float64),
                                       want[key].astype(np.float64), rtol=TOL, atol=TOL,
                                       err_msg=key)
        if case == "sharp":  # the resample fired: the weights are uniform
            np.testing.assert_allclose(got["weights"].numpy(), 1.0 / 32, rtol=1e-15)
        else:
            assert bool(got["lm_seen"].all())


def test_pf_predict_noise_equals_generator_route():
    b = ParticleBelief(torch.randn(3, 16, 4, generator=torch.Generator().manual_seed(0),
                                   dtype=torch.float64),
                       torch.full((3, 16), 1 / 16, dtype=torch.float64))
    u, std = torch.tensor([1.0, 0.1], dtype=torch.float64), (0.2, 0.05)
    drawn = tpf.pf_predict(b, u, 0.1, std, torch.Generator().manual_seed(4))
    noise = torch.randn(3, 16, 2, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    fed = tpf.pf_predict(b, u, 0.1, std, noise=noise)
    assert torch.equal(drawn.states, fed.states) and torch.equal(drawn.weights, fed.weights)
