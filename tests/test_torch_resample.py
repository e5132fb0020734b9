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


CHIP_SHAPES = ((256, 1024), (8192, 1024), (2048, 4096))  # chip_smoke.py's f32 shapes, D=4


@pytest.mark.parametrize("b,p", CHIP_SHAPES)
def test_launch_plan_stages_the_chip_shapes_by_tma(b, p):
    plan = trs._launch_plan(p, 4, torch.float32)
    assert plan.mode == trs.STAGED and plan.vector_stores
    assert plan.threads * plan.run >= p and plan.run % trs.RUN == 0
    assert plan.shared_bytes == (1 + 1 + 4) * p * 4  # weights, marks, four state channels
    assert plan.threads == (256 if p == 1024 else 512)


@pytest.mark.parametrize("p,aligned", [(1001, True), (257, True), (1024, False)])
def test_launch_plan_copies_rows_that_are_not_16_byte_aligned(p, aligned):
    plan = trs._launch_plan(p, 4, torch.float32, aligned)
    assert plan.mode == trs.COPIED and not plan.vector_stores
    assert plan.threads * plan.run >= p


def test_launch_plan_gathers_rows_too_large_for_a_block_from_global_memory():
    plan = trs._launch_plan(4096, 8, torch.float64)  # 9 x 32 KB + 16 KB of marks
    assert plan.mode == trs.DIRECT and plan.vector_stores
    assert plan.shared_bytes == 4096 * 8  # the CDF alone
    assert trs._launch_plan(1000, 4, torch.float64).mode == trs.STAGED  # 8000 B rows align


def test_no_launch_plan_exceeds_a_blocks_shared_memory():
    sizes = [*range(1, 1025), *range(1536, 58113, 512)]
    for dtype in (torch.float32, torch.float64):
        size = 4 if dtype == torch.float32 else 8
        for p in sizes:
            if p * size > trs._build.SHARED_BYTES_PER_BLOCK - trs.STATIC_SHARED_BYTES:
                with pytest.raises(ValueError, match="shared memory"):
                    trs._launch_plan(p, 1, dtype)
                continue
            for d in (0, 1, 4, 8):
                plan = trs._launch_plan(p, d, dtype)
                assert plan.shared_bytes + trs.STATIC_SHARED_BYTES <= 232448
                assert plan.threads % 32 == 0 and 32 <= plan.threads <= trs.MAX_THREADS
                assert plan.threads * plan.run >= p and plan.run % trs.RUN == 0


# (b, p, d, dtype, zero-weight runs, f64 indices exact, offset by one
# element): one case a branch of `_launch_plan` (staged by TMA, copied by
# cp.async where rows or pointers are not 16-byte aligned, states gathered
# from global memory) and CDFs flat across runs of zero weights. P=1000 in f64 is
# exact: the twin divides by P through `_numeric.true_div`, as the kernel does.
CUDA_CASES = {
    "staged f64": (257, 1024, 4, np.float64, False, True, False),
    "staged f32 P=4096": (64, 4096, 4, np.float32, False, False, False),
    "staged f64 P=1000": (33, 1000, 4, np.float64, False, True, False),
    "copied f32 P=1001": (33, 1001, 4, np.float32, False, False, False),
    "copied f32 offset views": (64, 1024, 4, np.float32, False, False, True),
    "direct f64 D=8 P=4096": (16, 4096, 8, np.float64, False, True, False),
    "flat CDF f32": (128, 1024, 4, np.float32, True, False, False),
    "flat CDF f64": (128, 1024, 4, np.float64, True, True, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_kernel_matches_twin_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    b, p, d, dtype, zero_runs, exact, offset = CUDA_CASES[case]
    w, u, s = make_case(b, p, d, dtype, skew=3.0, seed=4)
    if zero_runs:
        for row, start in zip(w, np.random.default_rng(5).integers(0, p - 300, size=b)):
            row[start:start + 300] = 0
    args = torch_args(w, u, s)
    cuda_args = tuple(a.cuda() for a in args)
    if offset:  # contiguous views one element into their buffers
        cuda_args = tuple(torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
                          for a in cuda_args)
        assert cuda_args[0].data_ptr() % 16 and cuda_args[0].is_contiguous()
    want_s, want_i, want_n = trs.systematic_resample_gather_plain(*cuda_args)
    before = trs.systematic_resample_gather.launches
    got_s, got_i, got_n = trs.systematic_resample_gather(*cuda_args)
    torch.cuda.synchronize()
    assert trs.systematic_resample_gather.launches == before + 1
    off = got_i != want_i
    assert (not exact or not off.any()) and off.double().mean() <= 1e-3
    np.testing.assert_array_equal(got_s.cpu().numpy(), gathered(s, got_i.cpu().numpy()))
    np.testing.assert_allclose(got_n.cpu().numpy(), want_n.cpu().numpy(), rtol=1e-5)
