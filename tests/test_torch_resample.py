"""Fused systematic resampling: kernel B3's wrapper (`ops.resample`, its
plain twin on the CPU) against the JAX package's `resample_reference` and
`systematic_resample_gather` (interpret mode, as
tests/test_resample_pallas.py runs it) on the same seeded numpy inputs.

Tolerances: against the JAX reference in f64, indices and states exact and
N_eff at rtol 1e-12. Against the JAX Pallas kernel in f32, whose prefix sum
is a matmul and so sums in another order, indices may differ by exactly one
in at most 1e-3 of the draws (the caveat of resample_pallas.py:40-46); the
states are the states at each side's own indices; N_eff at rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.ops import resample_pallas as jrs
from rust_robotics_tpu_torch.ops import resample as trs

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def make_case(b, p, d, dtype, skew=1.0, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(b, p)) ** skew + 1e-6).astype(dtype)
    u = rng.uniform(size=(b,)).astype(dtype)
    s = rng.standard_normal((b, d, p)).astype(dtype)
    return w, u, s


def torch_args(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def gathered(states, idx):
    return np.take_along_axis(states, idx[:, None, :].astype(np.int64), axis=2)


@pytest.mark.parametrize("b,p,d,skew", [(4, 256, 4, 1.0), (3, 1000, 2, 3.0), (2, 4096, 4, 3.0)])
def test_twin_matches_jax_reference_in_f64(b, p, d, skew):
    w, u, s = make_case(b, p, d, np.float64, skew)
    want_s, want_i, want_n = jrs.resample_reference(jnp.asarray(w), jnp.asarray(u), jnp.asarray(s))
    before = trs.systematic_resample_gather.launches
    for fn in (trs.systematic_resample_gather, trs.systematic_resample_gather_plain,
               trs.resample_reference):
        got_s, got_i, got_n = fn(*torch_args(w, u, s))
        assert got_i.dtype == torch.int32 and got_s.shape == (b, d, p) and got_n.shape == (b,)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-12)
    assert trs.systematic_resample_gather.launches == before  # CPU runs the twin


@pytest.mark.parametrize("b,p", [(4, 256), (2, 4096)])
def test_twin_matches_jax_pallas_kernel_in_f32(b, p):
    w, u, s = make_case(b, p, 4, np.float32, skew=3.0, seed=1)
    want_s, want_i, want_n = jrs.systematic_resample_gather(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(s), interpret=True)
    got_s, got_i, got_n = trs.systematic_resample_gather(*torch_args(w, u, s))
    got_i, want_i = got_i.numpy(), np.asarray(want_i)
    off = got_i != want_i
    assert off.mean() <= 1e-3, off.sum()
    assert np.all(np.abs(got_i[off].astype(np.int64) - want_i[off]) == 1)
    np.testing.assert_array_equal(got_s.numpy(), gathered(s, got_i))
    np.testing.assert_allclose(np.asarray(want_s), gathered(s, want_i), atol=1e-6)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-5)


@pytest.mark.parametrize("p,hot", [(128, 37), (2048, 777)])
def test_degenerate_weights_send_every_draw_to_the_one_particle(p, hot):
    b, d = 2, 3
    w = np.full((b, p), 1e-12, np.float32)
    w[:, hot] = 1.0
    u = np.array([0.25, 0.75], np.float32)
    s = np.random.default_rng(2).standard_normal((b, d, p)).astype(np.float32)
    got_s, got_i, got_n = trs.systematic_resample_gather(*torch_args(w, u, s))
    _, want_i, _ = jrs.systematic_resample_gather(jnp.asarray(w), jnp.asarray(u),
                                                  jnp.asarray(s), interpret=True)
    assert (got_i == hot).all() and np.all(np.asarray(want_i) == hot)
    np.testing.assert_array_equal(got_s.numpy(), np.broadcast_to(s[:, :, hot:hot + 1], (b, d, p)))
    assert (got_n < 1.5).all()


def test_uniform_weights_keep_every_particle_once():
    p = 128
    w, u = np.ones((1, p), np.float32), np.array([0.5], np.float32)
    s = np.random.default_rng(3).standard_normal((1, 2, p)).astype(np.float32)
    got_s, got_i, got_n = trs.systematic_resample_gather(*torch_args(w, u, s))
    np.testing.assert_array_equal(got_i[0].numpy(), np.arange(p))
    np.testing.assert_array_equal(got_s.numpy(), s)
    np.testing.assert_allclose(float(got_n[0]), p, rtol=1e-5)


def test_inputs_are_checked_as_the_jax_entry_checks_them():
    w, u, s = torch_args(*make_case(1, 1280, 2, np.float32))
    for fn in (trs.systematic_resample_gather, trs.systematic_resample_gather_plain):
        with pytest.raises(ValueError, match="512"):
            fn(w, u, s)
    with pytest.raises(ValueError, match="512"):
        jrs.systematic_resample_gather(jnp.asarray(w.numpy()), jnp.asarray(u.numpy()),
                                       jnp.asarray(s.numpy()), interpret=True)
    w, u, s = torch_args(*make_case(2, 64, 3, np.float32))
    with pytest.raises(ValueError, match="u must be"):
        trs.systematic_resample_gather(w, u[:1], s)
    with pytest.raises(ValueError, match="states must be"):
        trs.systematic_resample_gather(w, u, s[:, :, :32])
    with pytest.raises(TypeError, match="mixed dtypes"):
        trs.systematic_resample_gather(w, u.double(), s)
    with pytest.raises(TypeError, match="float32 or float64"):
        trs.systematic_resample_gather(w.half(), u.half(), s.half())
    with pytest.raises(ValueError, match="contiguous"):
        trs.systematic_resample_gather(w, u, s.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        trs.systematic_resample_gather(w.to("meta"), u.to("meta"), s.to("meta"))


@pytest.mark.cuda
def test_kernel_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    for b, p, dtype in ((257, 1024, np.float64), (64, 4096, np.float32)):
        args = torch_args(*make_case(b, p, 4, dtype, skew=3.0, seed=4))
        want_s, want_i, want_n = trs.systematic_resample_gather_plain(*args)
        before = trs.systematic_resample_gather.launches
        got_s, got_i, got_n = trs.systematic_resample_gather(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        assert trs.systematic_resample_gather.launches == before + 1
        off = got_i.cpu() != want_i
        assert off.double().mean() <= 1e-3
        np.testing.assert_array_equal(got_s.cpu().numpy(), gathered(args[2].numpy(),
                                                                    got_i.cpu().numpy()))
        np.testing.assert_allclose(got_n.cpu().numpy(), want_n.numpy(), rtol=1e-5)
