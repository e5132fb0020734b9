"""The blocked Cholesky (`ops.cholesky`, kernels B4/B5): its twin, which the
entries run on CPU tensors, against the JAX package's Pallas entries in
interpret mode (as tests/test_cholesky_pallas.py runs them), on the same
seeded SPD matrices m·mᵀ + n·I:
- `cholesky_blocked` against `cholesky_pallas` at n in {64, 128, 200, 384}
  in f64, atol 1e-10·n (test_cholesky_pallas.py:22), the strict upper
  triangle exactly 0;
- `cholesky_solve_blocked` against `cholesky_solve_pallas` at n=250 (both
  solve a·x = b to 1e-9, as test_cholesky_pallas.py:35 holds JAX);
- `cholesky_blocked_large` against `cholesky_pallas_large` at n in {96, 300}
  in f32, each within 5e-5 of the f64 factor relative to its largest entry
  (test_cholesky_pallas.py:100);
- the twin at the ragged sizes n in {1, 63, 65, 127, 129} (one short of,
  one past, a block) against `cholesky_pallas` at the same tolerance;
- the pivot clamp 1/sqrt(max(p, 1e-30)) on zero, tiny and negative pivots;
- the block width of csrc/cholesky.cu (`constexpr int kB`) against
  `ops/cholesky.py::BLOCK`, read from the source.
The kernel itself runs only on a card (the `cuda` tests below)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.ops.cholesky_pallas import (
    cholesky_pallas,
    cholesky_pallas_large,
    cholesky_solve_pallas,
)
from rust_robotics_tpu_torch.ops import cholesky as tc

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)


def spd(n, dtype=np.float64, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    m = rng.normal(size=(n, n))
    return (m @ m.T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("n", [64, 128, 200, 384])
def test_factor_matches_jax_pallas(n):
    a = spd(n)
    want = np.asarray(cholesky_pallas(jnp.asarray(a), interpret=True))
    before = tc.cholesky_blocked.launches
    got = tc.cholesky_blocked(torch.from_numpy(a))
    assert tc.cholesky_blocked.launches == before  # a CPU tensor runs the twin
    assert got.shape == (n, n) and got.dtype == torch.float64 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10 * n)
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    np.testing.assert_allclose((got @ got.T).numpy(), a, rtol=1e-12, atol=1e-12 * n)


@pytest.mark.parametrize("n", [1, 63, 65, 127, 129])
def test_twin_ragged_sizes_match_jax_pallas(n):
    a = spd(n)
    want = np.asarray(cholesky_pallas(jnp.asarray(a), interpret=True))
    got = tc.cholesky_blocked(torch.from_numpy(a))
    assert got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10 * n)
    assert float(torch.triu(got, 1).abs().max()) == 0.0


def test_kernel_block_width_matches_the_wrapper():
    source = Path(tc.__file__).resolve().parents[1] / "csrc" / "cholesky.cu"
    widths = re.findall(r"constexpr int kB = (\d+);", source.read_text())
    assert widths == [str(tc.BLOCK)]


def test_phase_stamps_need_a_card():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tc.cholesky_phase_stamps(torch.eye(3))


def test_twin_leaves_its_input_alone():
    a = torch.from_numpy(spd(70))
    copy = a.clone()
    tc.cholesky_blocked_plain(a)
    assert torch.equal(a, copy)


@pytest.mark.parametrize("rhs_shape", [(250, 3), (250,)])
def test_solve_matches_jax_pallas(rhs_shape):
    n = 250
    a = spd(n, seed=7)
    b = np.random.default_rng(8).normal(size=rhs_shape)
    want = np.asarray(cholesky_solve_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = tc.cholesky_solve_blocked(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == rhs_shape
    np.testing.assert_allclose(a @ got.numpy(), b, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.mark.parametrize("n", [96, 300])
def test_large_entry_matches_jax_pallas_large_in_f32(n):
    a = spd(n, np.float32)
    ref = np.linalg.cholesky(a.astype(np.float64))
    want = np.asarray(cholesky_pallas_large(jnp.asarray(a), interpret=True))
    got = tc.cholesky_blocked_large(torch.from_numpy(a))
    assert got.dtype == torch.float32
    for factor in (got.numpy(), want):
        assert np.abs(factor - ref).max() / np.abs(ref).max() < 5e-5
        assert np.all(np.triu(factor, 1) == 0.0)


def clamp_case(n=100):
    """Exact integer arithmetic with three clamped pivots in the last block
    (rows >= 64, so that no panel divides by them): row 70's pivot becomes
    exactly 0 after its coupling to row 10 is eliminated, row 80's is
    1e-40 and row 90's is -4."""
    a = 2.0 * np.eye(n)
    a[10, 10] = a[70, 70] = a[10, 70] = a[70, 10] = 1.0
    a[80, 80] = 1e-40
    a[90, 90] = -4.0
    return a


def test_pivot_clamp_matches_jax_pallas():
    a = clamp_case()
    want = np.asarray(cholesky_pallas(jnp.asarray(a), interpret=True))
    got = tc.cholesky_blocked(torch.from_numpy(a)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0.0)
    assert got[70, 70] == 0.0 and got[70, 10] == 1.0
    np.testing.assert_allclose([got[80, 80], got[90, 90]], [1e-25, -4e15], rtol=1e-15)


def test_inputs_are_checked():
    with pytest.raises(ValueError, match="square"):
        tc.cholesky_blocked(torch.zeros(3, 4))
    with pytest.raises(TypeError, match="float32 or float64"):
        tc.cholesky_blocked(torch.eye(3, dtype=torch.float16))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tc.cholesky_blocked(np.eye(3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tc.cholesky_blocked(torch.eye(3, device="meta"))
    assert tc.cholesky_blocked(torch.zeros(0, 0)).shape == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["cholesky_blocked", "cholesky_blocked_large"])
def test_kernel_matches_twin_on_cuda(entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    fn = getattr(tc, entry)
    sizes = [(200, np.float64), (1200, np.float32), (1025, np.float32), (2560, np.float32)]
    sizes += [(n, np.float32) for n in (1, 63, 65, 127, 129)]
    for n, dtype in sizes:
        a = torch.from_numpy(spd(n, dtype))
        want = tc.cholesky_blocked_plain(a)
        before = fn.launches
        got = fn(a.cuda())
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert float(torch.triu(got, 1).abs().max()) == 0.0
        ref = np.linalg.cholesky(a.double().numpy())
        tol = 1e-10 * n if dtype == np.float64 else 5e-5
        assert np.abs(got.cpu().double().numpy() - ref).max() / np.abs(ref).max() < tol
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=(1e-10 * n if dtype == np.float64 else 1e-3))


@pytest.mark.cuda
def test_kernel_pivot_clamp_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    a = torch.from_numpy(clamp_case())
    before = tc.cholesky_blocked.launches
    got = tc.cholesky_blocked(a.cuda()).cpu().numpy()
    assert tc.cholesky_blocked.launches == before + 1
    np.testing.assert_allclose(got, tc.cholesky_blocked_plain(a).numpy(), rtol=1e-15, atol=0.0)
    assert got[70, 70] == 0.0
    np.testing.assert_allclose([got[80, 80], got[90, 90]], [1e-25, -4e15], rtol=1e-15)


@pytest.mark.cuda
def test_phase_stamps_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    a = torch.from_numpy(spd(300, np.float32)).cuda()
    before = tc.cholesky_blocked.launches
    got, stamps = tc.cholesky_phase_stamps(a)
    torch.cuda.synchronize()
    assert tc.cholesky_blocked.launches == before  # a measurement, not counted
    assert stamps.shape == (3 + 6 * 4,)  # 300 pads to 320: five blocks, four panels
    assert bool((stamps.diff() >= 0).all()) and int(stamps[0]) > 0
    torch.testing.assert_close(got, tc.cholesky_blocked(a), rtol=0, atol=0)
