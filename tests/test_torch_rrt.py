"""RRT, RRT* and the sampling-planner variants (`planning/{rrt,
rrt_variants}.py`) against the JAX package's: JAX on the CPU at x64 under
`jax.jit`, torch in float64 on the CPU, on the obstacle courses of
tests/test_rrt.py and test_rrt_variants.py with trees of 48-64 nodes (the
JAX tests grow 300-600). The port gets JAX's own draws: the uniforms its
split keys give, in the order its loops draw them.

Tolerances: node indices, parents, counts, active masks and paths
exactly; positions and costs within 1e-12 (a jitted loop body may fuse a
multiply-add). Each tree planner's 4-lane forest is bitwise its 4 solo
runs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_robotics_tpu.planning import rrt as jr
from rust_robotics_tpu.planning import rrt_variants as jv
from rust_robotics_tpu_torch import convert
from rust_robotics_tpu_torch.planning import rrt as tr
from rust_robotics_tpu_torch.planning import rrt_variants as tv

torch.set_num_threads(1)  # one intra-op thread: the tests run a process a core (xdist)

F64 = torch.float64
OBS = np.array([[5.0, 5.0], [3.0, 6.0], [7.0, 4.0]])
RAD = np.array([1.0, 0.8, 0.8])
START, GOAL = np.array([0.0, 0.0]), np.array([10.0, 10.0])
N = 64
JCFG = jr.RRTConfig(expand_dis=2.0, max_nodes=N, connect_radius=3.0, goal_threshold=1.5)
TCFG = tr.RRTConfig(expand_dis=2.0, max_nodes=N, connect_radius=3.0, goal_threshold=1.5)
SEEDS = (0, 1, 2, 3)


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               atol=atol, rtol=0.0)


def same_tree(got, want):
    assert np.array_equal(got.parents.numpy(), np.asarray(want.parents))
    assert np.array_equal(got.active.numpy(), np.asarray(want.active))
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    close(got.nodes, want.nodes)
    close(got.costs, want.costs)


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(dataclasses.astuple(a), dataclasses.astuple(b)))


def keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def uniforms(k, shape):
    return jax.random.uniform(k, shape)


@jax.jit
def _split2(k):
    return jax.random.split(k)


def rrt_draws(seed):
    """rrt_plan's: iteration i draws uniform(split(keys[i])[0], (3,))."""
    return np.asarray(jax.vmap(lambda k: uniforms(jax.random.split(k)[0], (3,)))(
        keys(seed, N))[:N - 1])


def informed_draws(seed):
    """informed_rrt_star_plan's: u from k1, then sample_informed's disk
    and box uniforms from split(k2)."""
    def one(k):
        k1, k2 = jax.random.split(k)
        ka, kb = jax.random.split(k2)
        return jnp.concatenate([uniforms(k1, ())[None], uniforms(ka, (2,)), uniforms(kb, (2,))])
    return np.asarray(jax.vmap(one)(keys(seed, N))[:N - 1])


def connect_draws(seed):
    return np.asarray(jax.vmap(lambda k: uniforms(k, (2,)))(keys(seed, N))[:N - 1])


@functools.lru_cache(maxsize=None)
def _jit_rrt(star):
    """One compiled JAX planner per `star`, shared by every seed."""
    return jax.jit(lambda k: jr.rrt_plan(k, jnp.asarray(START), jnp.asarray(GOAL),
                                         jnp.asarray(OBS), jnp.asarray(RAD), JCFG, star=star))


@functools.lru_cache(maxsize=None)
def jax_rrt(seed, star):
    return _jit_rrt(star)(jax.random.PRNGKey(seed))


_jit_extract = jax.jit(jr.extract_rrt_path, static_argnums=2)


@pytest.mark.parametrize("star", [False, True])
def test_rrt_and_rrt_star_match_jax_with_its_draws(star):
    tree, best, cost = jax_rrt(0, star)
    got = tr.rrt_plan(None, START, GOAL, OBS, RAD, TCFG, star=star, draws=t64(rrt_draws(0)),
                      dtype=F64, device="cpu")
    same_tree(got[0], tree)
    assert int(got[1]) == int(best)
    close(got[2], cost)
    pts, mask = _jit_extract(tree, best, 64)
    conv = convert.tree_from_numpy(*(np.asarray(getattr(tree, f)) for f in (
        "nodes", "parents", "costs", "active", "count")), device="cpu")
    gpts, gmask = tr.extract_rrt_path(conv, got[1], 64)
    assert np.array_equal(gmask.numpy(), np.asarray(mask))
    close(gpts, pts)
    if star:
        assert float(cost) < 1e17


def forest_lanes_equal_solo_runs(star):
    """A 4-lane forest of SEEDS' draws, each lane bitwise its solo run."""
    draws = t64(np.stack([rrt_draws(s) for s in SEEDS]))
    forest = tr.rrt_plan(None, START, GOAL, OBS, RAD, TCFG, star=star, draws=draws, dtype=F64,
                         device="cpu")
    for lane in range(4):
        solo = tr.rrt_plan(None, START, GOAL, OBS, RAD, TCFG, star=star, draws=draws[lane],
                           dtype=F64, device="cpu")
        lane_tree = tr.Tree(*(getattr(forest[0], f.name)[lane]
                              for f in dataclasses.fields(tr.Tree)))
        assert bitwise(lane_tree, solo[0]) and torch.equal(forest[1][lane], solo[1])
        assert torch.equal(forest[2][lane], solo[2])
    return forest


def test_rrt_star_forest_lanes_equal_solo_runs():
    forest = forest_lanes_equal_solo_runs(star=True)
    tree, best, cost = jax_rrt(1, True)
    assert int(forest[1][1]) == int(best)
    close(forest[2][1], cost)


def test_rrt_forest_lanes_equal_solo_runs():
    forest = forest_lanes_equal_solo_runs(star=False)
    tree, best, cost = jax_rrt(0, False)
    assert int(forest[1][0]) == int(best)
    close(forest[2][0], cost)


def test_informed_rrt_star_matches_jax_and_lanes_equal_solo_runs():
    want = jax.jit(lambda k: jv.informed_rrt_star_plan(k, jnp.asarray(START), jnp.asarray(GOAL),
                                                       jnp.asarray(OBS), jnp.asarray(RAD), JCFG))(
        jax.random.PRNGKey(0))
    draws = t64(np.stack([informed_draws(s) for s in SEEDS]))
    forest = tv.informed_rrt_star_plan(None, START, GOAL, OBS, RAD, TCFG, draws=draws,
                                       dtype=F64, device="cpu")
    lane0 = tr.Tree(*(getattr(forest[0], f.name)[0] for f in dataclasses.fields(tr.Tree)))
    same_tree(lane0, want[0])
    assert int(forest[1][0]) == int(want[1])
    close(forest[2][0], want[2])
    for lane in range(4):
        solo = tv.informed_rrt_star_plan(None, START, GOAL, OBS, RAD, TCFG, draws=draws[lane],
                                         dtype=F64, device="cpu")
        assert torch.equal(forest[0].nodes[lane], solo[0].nodes)
        assert torch.equal(forest[0].costs[lane], solo[0].costs)
        assert torch.equal(forest[0].parents[lane], solo[0].parents)


@pytest.mark.parametrize("greedy", [True, False])
def test_rrt_connect_and_bidirectional_match_jax(greedy):
    fn = jv.rrt_connect_plan if greedy else jv.bidirectional_rrt_plan
    want = jax.jit(lambda k: fn(k, jnp.asarray(START), jnp.asarray(GOAL), jnp.asarray(OBS),
                                jnp.asarray(RAD), JCFG))(jax.random.PRNGKey(1))
    draws = t64(np.stack([connect_draws(s) for s in SEEDS]))
    tfn = tv.rrt_connect_plan if greedy else tv.bidirectional_rrt_plan
    forest = tfn(None, START, GOAL, OBS, RAD, TCFG, draws=draws, dtype=F64, device="cpu")
    lane1 = tr.Tree(*(getattr(forest[0], f.name)[1] for f in dataclasses.fields(tr.Tree)))
    same_tree(lane1, want[0])
    assert [int(v[1]) for v in forest[1][:2]] == [int(v) for v in want[1][:2]]
    close(forest[2][1], want[2])
    for lane in (0, 3):
        solo = tfn(None, START, GOAL, OBS, RAD, TCFG, draws=draws[lane], dtype=F64, device="cpu")
        assert torch.equal(forest[0].nodes[lane], solo[0].nodes)
        assert all(torch.equal(a[lane], b) for a, b in zip(forest[1], solo[1]))


def test_graph_shortest_path_and_extraction_match_jax():
    big = jv.BIG
    w = np.full((3, 3), big)
    w[0, 1] = w[1, 0] = 1.0
    w[1, 2] = w[2, 1] = 2.0
    w[0, 2] = w[2, 0] = 4.0
    d = tv.graph_shortest_path(t64(w), 0)
    close(d, [0.0, 1.0, 3.0])
    idx, mask = tv.extract_graph_path(t64(w), d, 0, 2, max_len=8)
    want = jv.extract_graph_path(jnp.asarray(w), jnp.asarray(d.numpy()), 0, 2, max_len=8)
    assert np.array_equal(idx.numpy(), np.asarray(want[0]))
    assert np.array_equal(mask.numpy(), np.asarray(want[1]))
    rng = np.random.default_rng(5)
    w = np.where(rng.random((40, 40)) < 0.15, rng.uniform(0.5, 3.0, (40, 40)), big)
    want = jax.jit(jv.graph_shortest_path, static_argnums=(1, 2))(jnp.asarray(w), 0)
    close(tv.graph_shortest_path(t64(w), 0), want)


def test_fmt_rrg_and_bit_star_match_jax():
    gcfg = dict(num_samples=48, connect_radius=3.0, batches=2, batch_size=24)
    jg, tg = jv.GraphPlannerConfig(**gcfg), tv.GraphPlannerConfig(**gcfg)
    args = (jnp.asarray(START), jnp.asarray(GOAL), jnp.asarray(OBS), jnp.asarray(RAD))
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda k: jv.fmt_star_plan(k, *args, jg))(key)
    got = tv.fmt_star_plan(None, START, GOAL, OBS, RAD, tg, draws=t64(uniforms(key, (48, 2))),
                           dtype=F64, device="cpu")
    close(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    close(got[3], want[3])

    want = jax.jit(lambda k: jv.rrg_plan(k, *args, JCFG))(jax.random.PRNGKey(4))
    got = tv.rrg_plan(None, START, GOAL, OBS, RAD, TCFG, draws=t64(rrt_draws(4)), dtype=F64,
                      device="cpu")
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    close(got[3], want[3])

    key = jax.random.PRNGKey(5)

    def bit_draws(bk):
        def one(k):
            ka, kb = jax.random.split(k)
            return jnp.concatenate([uniforms(ka, (2,)), uniforms(kb, (2,))])
        return jax.vmap(one)(jax.random.split(bk, 24))

    draws = np.asarray(jax.vmap(bit_draws)(jax.random.split(key, 2)))
    want = jax.jit(lambda k: jv.bit_star_plan(k, *args, jg))(key)
    got = tv.bit_star_plan(None, START, GOAL, OBS, RAD, tg, draws=t64(draws), dtype=F64,
                           device="cpu")
    close(got[0], want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    close(got[3], want[3])
    close(got[4], want[4])
    assert np.all(np.diff(got[4].numpy()) <= 1e-9)


def test_sobol_sequence_rrt_sobol_and_shortcut_match_jax():
    want = np.asarray(jv.sobol_sequence_2d(256))
    got = tv.sobol_sequence_2d(256, F64, "cpu").numpy()
    assert np.array_equal(got, want)
    for star in (False, True):
        jt = jax.jit(lambda: jv.rrt_sobol_plan(jnp.asarray(START), jnp.asarray(GOAL),
                                               jnp.asarray(OBS), jnp.asarray(RAD), JCFG,
                                               star=star))()
        gt = tv.rrt_sobol_plan(START, GOAL, OBS, RAD, TCFG, star=star, dtype=F64, device="cpu")
        same_tree(gt[0], jt[0])
        assert int(gt[1]) == int(jt[1])

    pts = np.array([[0.0, 0.0], [0.0, 3.0], [1.0, 8.0], [2.0, 9.5], [5.0, 9.8], [8.0, 9.9],
                    [10.0, 10.0]])
    key = jax.random.PRNGKey(6)
    want = jv.shortcut_path(key, jnp.asarray(pts), jnp.ones(7, bool), jnp.asarray(OBS),
                            jnp.asarray(RAD), iters=16)
    draws = np.asarray(jax.vmap(lambda k: uniforms(jax.random.split(k)[0], (2,)))(
        jax.random.split(key, 16)))
    got = tv.shortcut_path(None, t64(pts), torch.ones(7, dtype=torch.bool), OBS, RAD, iters=16,
                           draws=t64(draws))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])
