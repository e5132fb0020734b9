"""The temporally parallel Kalman filter and RTS smoother
(`filters/smoother.py`) against the JAX package's, on numpy inputs made
from a seed: JAX on the CPU at x64, torch in float64 on the CPU.

`associative_scan` follows JAX's odd/even recursion, so it is held to
`jax.lax.associative_scan` bitwise, on a combine whose result depends on
the order of association (exactly, and through its rounding), at lengths
that are not powers of two, forward and reversed. The filters and smoothers are held at
1e-12 (the same combines in the same order; the only differences are the
LU solves' and matrix products' rounding, ~1e-14 measured on the means of
magnitude ~10), the sequential loops too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.filters import smoother as js
from rust_robotics_tpu_torch.filters import smoother as ts
from rust_robotics_tpu_torch.models.motion import unicycle_propagate

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

ATOL = 1e-12
NAMES = ("parallel_kalman_filter", "sequential_kalman_filter", "parallel_rts_smoother",
         "sequential_rts_smoother")


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0.0)


def _pair(a, b):
    """Subtraction is not associative, so the first result shows the tree
    exactly (small integers: no rounding); addition is associative but not
    in rounding, so the second shows it through the rounding of terms that
    span sixteen decades. Neither can be contracted into an FMA."""
    return a[0] - b[0], a[1] + b[1]


@pytest.mark.parametrize("t", [1, 2, 7, 37, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_is_jax_recursion(t, reverse):
    rng = np.random.default_rng(t)
    x = rng.integers(-9, 10, size=(t, 3)).astype(np.float64)
    y = rng.normal(size=(t, 2, 2)) * 10.0 ** rng.uniform(-8, 8, size=(t, 2, 2))
    want = jax.jit(lambda e: jax.lax.associative_scan(_pair, e, reverse=reverse))(
        (jnp.asarray(x), jnp.asarray(y)))
    got = ts.associative_scan(_pair, (t64(x), t64(y)), reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _system(seed, t, n=4, m=2, lead=()):
    rng = np.random.default_rng(seed)
    fs = np.eye(n) + 0.05 * rng.normal(size=lead + (t, n, n))
    qs = np.broadcast_to(0.01 * np.eye(n), lead + (t, n, n)).copy()
    h = rng.normal(size=(m, n))
    r = 0.1 * np.eye(m)
    cs = 0.1 * rng.normal(size=lead + (t, n))
    zs = rng.normal(size=lead + (t, m))
    m0 = 0.1 * rng.normal(size=lead + (n,))
    p0 = np.broadcast_to(np.eye(n), lead + (n, n)).copy()
    return fs, qs, h, r, zs, m0, p0, cs


T = 37
jax_parallel = jax.jit(js.parallel_rts_smoother)
jax_sequential = jax.jit(js.sequential_rts_smoother)


@functools.lru_cache(maxsize=None)
def _jax_results(seed):
    """Every function's JAX result at T: the smoothers return the filters'
    results beside their own, so two compiles serve the four."""
    args = map(jnp.asarray, _system(seed, T))
    par, seq = jax_parallel(*args), jax_sequential(*map(jnp.asarray, _system(seed, T)))
    return {"parallel_kalman_filter": par[2:], "sequential_kalman_filter": seq[2:],
            "parallel_rts_smoother": par, "sequential_rts_smoother": seq}


@pytest.mark.parametrize("name", NAMES)
def test_filters_and_smoothers_match_jax(name):
    args = _system(0, T)
    got = getattr(ts, name)(*map(t64, args))
    for g, w in zip(got, _jax_results(0)[name]):
        close(g, w)


def test_without_drift_matches_jax():
    """cs=None is a drift of zeros, as in the JAX package."""
    fs, qs, h, r, zs, m0, p0, cs = _system(1, T)
    want = jax_parallel(*map(jnp.asarray, (fs, qs, h, r, zs, m0, p0, np.zeros_like(cs))))
    got = ts.parallel_rts_smoother(*map(t64, (fs, qs, h, r, zs, m0, p0)))
    for g, w in zip(got, want):
        close(g, w)


def test_batch_matches_vmap():
    args = _system(2, T, lead=(2,))
    fs, qs, h, r, zs, m0, p0, cs = map(jnp.asarray, args)
    want = jax.jit(jax.vmap(js.parallel_rts_smoother, in_axes=(0, 0, None, None, 0, 0, 0, 0)))(
        fs, qs, h, r, zs, m0, p0, cs)
    got = ts.parallel_rts_smoother(*map(t64, args))
    for g, w in zip(got, want):
        close(g, w)
    seq = ts.sequential_rts_smoother(*map(t64, args))
    for g, w in zip(seq, want):
        close(g, w, 1e-10)


def test_combines_match_jax():
    rng = np.random.default_rng(3)
    n = 4

    def spd(k):
        a = rng.normal(size=(k, n, n))
        return 0.1 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n)

    e1 = (rng.normal(size=(5, n, n)), rng.normal(size=(5, n)), spd(5), rng.normal(size=(5, n)),
          spd(5))
    e2 = (rng.normal(size=(5, n, n)), rng.normal(size=(5, n)), spd(5), rng.normal(size=(5, n)),
          spd(5))
    want = jax.jit(jax.vmap(js._filter_combine))(tuple(map(jnp.asarray, e1)),
                                                 tuple(map(jnp.asarray, e2)))
    got = ts._filter_combine(tuple(map(t64, e1)), tuple(map(t64, e2)))
    for g, w in zip(got, want):
        close(g, w)
    want = jax.vmap(js._smoother_combine)(tuple(map(jnp.asarray, e1[:3])),
                                          tuple(map(jnp.asarray, e2[:3])))
    got = ts._smoother_combine(tuple(map(t64, e1[:3])), tuple(map(t64, e2[:3])))
    for g, w in zip(got, want):
        close(g, w)


def test_elements_match_jax():
    fs, qs, h, r, zs, m0, p0, cs = _system(4, 9)
    want = jax.jit(js._filter_elements)(*map(jnp.asarray, (fs, qs, h, r, zs, cs, m0, p0)))
    got = ts._filter_elements(*map(t64, (fs, qs, h, r, zs, cs, m0, p0)))
    for g, w in zip(got, want):
        close(g, w)
    ms, ps = _jax_results(0)["sequential_kalman_filter"]
    fs, qs, _, _, _, _, _, cs = _system(0, T)
    want = jax.jit(js._smoother_elements)(*map(jnp.asarray, (fs, qs, cs)), ms, ps)
    got = ts._smoother_elements(*map(t64, (fs, qs, cs, ms, ps)))
    for g, w in zip(got, want):
        close(g, w)


def test_ekf_smooth_unicycle_matches_jax_and_improves():
    """tests/test_smoother.py's unicycle run at T = 60, numpy noise."""
    dt, t = 0.1, 60
    rng = np.random.default_rng(5)
    us = np.stack([np.full(t, 1.0), 0.2 * np.sin(0.1 * np.arange(t))], -1)
    x = torch.zeros(4, dtype=torch.float64)
    truth = []
    for k in range(t):
        x = unicycle_propagate(x, t64(us[k]), dt)
        truth.append(x.numpy())
    truth = np.stack(truth)
    zs = truth[:, :2] + 0.3 * rng.normal(size=(t, 2))
    q = np.diag([0.05, 0.05, 0.01, 0.1]) ** 2
    r = np.diag([0.3, 0.3]) ** 2
    want = jax.jit(js.ekf_smooth_unicycle, static_argnums=2)(
        jnp.asarray(zs), jnp.asarray(us), dt, jnp.asarray(q), jnp.asarray(r), jnp.zeros(4),
        jnp.eye(4))
    got = ts.ekf_smooth_unicycle(t64(zs), t64(us), dt, t64(q), t64(r),
                                 torch.zeros(4, dtype=torch.float64),
                                 torch.eye(4, dtype=torch.float64))
    for key in want:
        close(got[key], want[key], 1e-10)
    rmse = {k: np.sqrt(np.mean(np.sum((got[k][:, :2].numpy() - truth[:, :2]) ** 2, -1)))
            for k in ("filtered_means", "smoothed_means")}
    assert rmse["smoothed_means"] < rmse["filtered_means"], rmse
