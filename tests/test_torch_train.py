"""The port's DP+TP training step (rust_robotics_tpu_torch/train.py) against
JAX's (rust_robotics_tpu/train.py).

The sharded step runs on 2 and 4 gloo ranks ((2, 1) and (2, 2) meshes),
spawned once per mesh size (tests/torch_dist_workers.py), on batches JAX's
`synthesize_batch` draws. In f64 its loss, grads and Adam steps must equal
the port's one-process run (a (1, 1) mesh) within 1e-12, and JAX's
one-device oracle (`make_training_step` on a (1, 1) mesh, `jax.grad` of
its loss) within 1e-10; the loss also equals JAX's loss on a mesh of the
same size. In f32 the loss is held to JAX's at the dryrun's rtol 1e-4
(`__graft_entry__.py::dryrun_multichip`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_workers as workers
from rust_robotics_tpu import train as jtrain
from rust_robotics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rust_robotics_tpu_torch import train as ttrain

WORLDS = (2, 4)
LR = 0.05
STEPS = 3


def _batch(seed, dtype, batch=8, steps=6, num_landmarks=16):
    arrays = jtrain.synthesize_batch(jax.random.PRNGKey(seed), batch=batch, steps=steps,
                                     num_landmarks=num_landmarks, dtype=dtype)
    return tuple(np.asarray(a) for a in arrays)


BATCHES = {"f64": _batch(1, jnp.float64), "f32": _batch(1, jnp.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {w: workers.run_spmd(workers.train_program, w, tmp_path_factory.mktemp("train"),
                               BATCHES, LR, STEPS) for w in WORLDS}
    out[1] = [workers.run_one_process(workers.train_program, BATCHES, LR, STEPS)]
    return out


@functools.lru_cache(maxsize=None)
def _jax_oracle(name):
    """JAX's one-device oracle: loss, grads, and STEPS Adam steps."""
    dtype = jnp.float64 if name == "f64" else jnp.float32
    arrays = tuple(jnp.asarray(a) for a in BATCHES[name])
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    loss, grads = jax.jit(jax.value_and_grad(jtrain.make_loss(mesh)))(
        jtrain.init_params(dtype), *arrays)
    init_fn, step_fn = jtrain.make_training_step(mesh, learning_rate=LR)
    params, state = init_fn(dtype)
    losses, steps = [], []
    for _ in range(STEPS):
        params, state, step_loss = step_fn(params, state, *arrays)
        losses.append(float(step_loss))
        steps.append((np.asarray(params.log_q), np.asarray(params.log_r)))
    return float(loss), (np.asarray(grads.log_q), np.asarray(grads.log_r)), losses, steps


@functools.lru_cache(maxsize=None)
def _jax_sharded(world, name):
    """JAX's loss and grads on a mesh of `world` virtual devices."""
    dtype = jnp.float64 if name == "f64" else jnp.float32
    arrays = tuple(jnp.asarray(a) for a in BATCHES[name])
    loss, grads = jax.jit(jax.value_and_grad(jtrain.make_loss(jax_make_mesh(world))))(
        jtrain.init_params(dtype), *arrays)
    return float(loss), (np.asarray(grads.log_q), np.asarray(grads.log_r))


def _np(ts):
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_equals_one_process_run(runs, world):
    one = runs[1][0]["f64"]
    assert runs[1][0]["shape"] == (1, 1)
    for out in runs[world]:
        assert out["shape"] == ((2, 1) if world == 2 else (2, 2))
        got = out["f64"]
        for key in ("loss", "loss_only", "losses"):
            np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), rtol=1e-12, atol=0)
        for key in ("grads", "params1", "params"):
            for g, o in zip(_np(got[key]), _np(one[key])):
                np.testing.assert_allclose(g, o, rtol=1e-12, atol=1e-15, err_msg=key)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_loss_grads_and_adam_equal_the_jax_oracle(runs, world):
    loss, grads, losses, steps = _jax_oracle("f64")
    for out in runs[world]:
        got = out["f64"]
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-10)
        for g, w in zip(_np(got["grads"]), grads):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=1e-10)
        for g, w in zip(_np(got["params1"]), steps[0]):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
        for g, w in zip(_np(got["params"]), steps[-1]):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
        assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_loss_equals_jax_on_a_mesh_of_the_same_size(runs, world):
    loss, _ = _jax_sharded(world, "f64")
    for out in runs[world]:
        np.testing.assert_allclose(float(out["f64"]["loss"]), loss, rtol=1e-10)
    loss32, _ = _jax_sharded(world, "f32")
    for out in runs[world]:
        assert out["f32"]["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(out["f32"]["loss"]), loss32, rtol=1e-4)
        assert np.all(np.isfinite(out["f32"]["losses"].numpy()))


@pytest.mark.parametrize("world", WORLDS)
def test_jax_sharded_grads_equal_its_oracle(world):
    """The reference itself: JAX's sharded loss and grads on a mesh of
    `world` devices equal its one-device oracle's, so the port is held to
    the oracle with nothing to record against JAX's sharded program."""
    loss, grads = _jax_sharded(world, "f64")
    want_loss, want_grads, _, _ = _jax_oracle("f64")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-12)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)


def test_innovation_nll_and_range_term_equal_jax():
    controls, meas, ranges, landmarks, init_mean = _batch(0, jnp.float64, batch=4, steps=8)
    jp = jtrain.init_params(jnp.float64)
    jnll, jxy = jtrain.ekf_innovation_nll(jp, jnp.asarray(controls), jnp.asarray(meas),
                                          jnp.asarray(init_mean))
    tp = ttrain.init_params(torch.float64, device="cpu")
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    nll, xy = ttrain.ekf_innovation_nll(tp, t(controls), t(meas), t(init_mean))
    assert nll.shape == (4,) and xy.shape == (4, 8, 2)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=1e-12)
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=0, atol=1e-12)
    lm = ttrain.landmark_range_sq_error(xy, t(landmarks), t(ranges))
    jlm = jtrain.landmark_range_sq_error(jxy, jnp.asarray(landmarks), jnp.asarray(ranges))
    np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), rtol=1e-12)


def test_softplus_is_jax_softplus_beyond_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.5, 20.0, 20.5, 40.0])
    got = ttrain._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-15)
    assert got[-2] > 20.5  # F.softplus gives 20.5 itself above its threshold


def test_adam_update_equals_optax():
    rng = np.random.default_rng(3)
    params = ttrain.SysIdParams(*(torch.from_numpy(rng.standard_normal(n)) for n in (4, 2)))
    jparams = jtrain.SysIdParams(*(jnp.asarray(p.numpy()) for p in params.tensors()))
    tx = optax.adam(0.05)
    jstate, state = tx.init(jparams), ttrain.adam_init(params)
    for _ in range(3):
        g = [rng.standard_normal(n) for n in (4, 2)]
        params, state = ttrain.adam_update(
            params, ttrain.SysIdParams(*(torch.from_numpy(a) for a in g)), state, 0.05)
        updates, jstate = tx.update(jtrain.SysIdParams(*(jnp.asarray(a) for a in g)), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for a, b in zip(params.tensors(), (jparams.log_q, jparams.log_r)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)


def test_synthesize_batch_shapes_and_seed():
    a = ttrain.synthesize_batch(3, batch=4, steps=5, num_landmarks=6, dtype=torch.float64,
                                device="cpu")
    b = ttrain.synthesize_batch(torch.Generator().manual_seed(3), batch=4, steps=5,
                                num_landmarks=6, dtype=torch.float64, device="cpu")
    assert [tuple(x.shape) for x in a] == [(4, 5, 2), (4, 5, 2), (4, 5, 6), (6, 2), (4, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
