"""Geometric sampling-planner variants: informed RRT*, RRT-Connect,
bidirectional RRT, RRG, FMT*, BIT*, the Sobol-driven RRT, stochastic
shortcutting.

The port of rust_robotics_tpu/planning/rrt_variants.py. Reference:
crates/rust_robotics_planning/src/ — informed_rrt_star.rs,
rrt_connect.rs / bidirectional_rrt.rs, rrg.rs, fmt_star.rs,
batch_informed_rrt_star.rs, rrt_sobol.rs, rrt_path_smoothing.rs.

Trees and sample sets are fixed-capacity tensors with active masks, grown
by masked updates with no read (`planning/rrt.py`), with leading batch
dims as lanes. The graph planners (RRG, FMT*, BIT*) materialize the r-disk
graph as a masked [..., N, N] cost matrix and take the single-source
min-plus fixpoint D = min(D, min_j D_j + W_ji), the costs FMT*/RRG return
on the same graph; the fixpoint reads its flag once every READ_EVERY
relaxations. The Sobol sequence is exact bit arithmetic on int64 lanes
(30-bit values). Randomness is `draws=` (the uniforms JAX's split keys
give) or a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import linspace, norm2, sqrt_rn
from rust_robotics_tpu_torch.control._small import rsum, take, take_rows
from rust_robotics_tpu_torch.planning.rrt import (
    BIG,
    RRTConfig,
    Tree,
    _inputs,
    _steer,
    area,
    choose_parent,
    edge_collision_free,
    goal_anchor,
    init_tree,
    insert,
    mul_add,
    rewire,
    rrt_plan,
)

__all__ = [
    "informed_rrt_star_plan",
    "rrt_connect_plan",
    "bidirectional_rrt_plan",
    "rrg_plan",
    "fmt_star_plan",
    "bit_star_plan",
    "sobol_sequence_2d",
    "rrt_sobol_plan",
    "shortcut_path",
    "graph_shortest_path",
    "extract_graph_path",
    "GraphPlannerConfig",
]

# a fixpoint reads its flag once every this many relaxations
READ_EVERY = 8


def _rand(generator, shape, like):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# informed sampling (informed_rrt_star.rs: prolate hyperspheroid)


def sample_informed(u, start, goal, c_best, lo, hi):
    """A uniform sample of the ellipse {x : |x−s| + |x−g| <= c_best}, or
    of the whole area while no solution exists (c_best >= BIG/2). u [...,
    4]: the disk's two uniforms, then the box's two."""
    c_min = norm2(goal - start)
    center = 0.5 * (start + goal)
    theta = torch.atan2(goal[..., 1] - start[..., 1], goal[..., 0] - start[..., 0])
    c, s = torch.cos(theta), torch.sin(theta)
    have = c_best < BIG / 2
    cb = torch.where(have, torch.maximum(c_best, c_min + 1e-9), c_min + 1.0)
    r1 = cb / 2.0
    r2 = sqrt_rn(torch.clamp(cb**2 - c_min**2, min=1e-18)) / 2.0
    r = sqrt_rn(u[..., 0])
    ang = 2 * math.pi * u[..., 1]
    b0, b1 = r1 * (r * torch.cos(ang)), r2 * (r * torch.sin(ang))
    ell = center + torch.stack([c * b0 + -s * b1, s * b0 + c * b1], -1)
    ell = torch.minimum(torch.maximum(ell, lo), hi)
    box = mul_add(u[..., 2:4], hi - lo, lo)
    return torch.where(have[..., None], ell, box)


def informed_rrt_star_plan(generator, start, goal, obstacles, radii,
                           cfg: RRTConfig = RRTConfig(), draws=None, dtype=None, device=None):
    """Informed RRT* (informed_rrt_star.rs): RRT* whose sampling domain
    shrinks to the solution ellipse once a first path is found. Iteration
    i samples the goal where draws[..., i, 0] < goal_sample_rate, else
    `sample_informed(draws[..., i, 1:5])`: draws [..., max_nodes − 1, 5].
    Returns (Tree, best goal node, cost), as `rrt_plan`."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    n = cfg.max_nodes
    lo, hi = area(cfg, start.dtype, start.device)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = _rand(generator, batch + (n - 1, 5), start)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    start, goal = start.expand(batch + (2,)), goal.expand(batch + (2,))
    tree = init_tree(start, n)
    for i in range(n - 1):
        u = draws[..., i, :]
        _, c_best = goal_anchor(tree, goal, cfg)
        sample = torch.where(u[..., :1] < cfg.goal_sample_rate, goal,
                             sample_informed(u[..., 1:], start, goal, c_best, lo, hi))
        _, near_pt, new_pt, _ = _steer(tree, sample, cfg.expand_dis)
        ok = edge_collision_free(near_pt, new_pt, obstacles, radii, cfg.edge_checks)
        idx = tree.count
        parent, new_cost, dn, near, free_to = choose_parent(tree, new_pt, obstacles, radii, cfg)
        ok = ok & (new_cost < BIG)
        tree = insert(tree, ok, new_pt, parent, new_cost)
        # rewire through the new node, on the near set and edges taken
        # before the insertion (informed_rrt_star.rs)
        through = new_cost[..., None] + dn
        better = ok[..., None] & near & free_to & (through < tree.costs)
        tree = rewire(tree, better, idx, through)
    best, total = goal_anchor(tree, goal, cfg)
    return tree, best, total


# ---------------------------------------------------------------------------
# dual-tree planners (rrt_connect.rs / bidirectional_rrt.rs)


def _extend(tree, target, obstacles, radii, cfg):
    """One EXTEND of `tree` toward `target`: (tree, new slot, ok)."""
    n = cfg.max_nodes
    nearest, near_pt, new_pt, step = _steer(tree, target, cfg.expand_dis)
    ok = edge_collision_free(near_pt, new_pt, obstacles, radii, cfg.edge_checks)
    ok = ok & ~(tree.count >= n)
    idx = torch.clamp(tree.count, max=n - 1)
    put = (torch.arange(n, device=ok.device) == idx[..., None]) & ok[..., None]
    tree = Tree(nodes=torch.where(put[..., None], new_pt[..., None, :], tree.nodes),
                parents=torch.where(put, nearest[..., None], tree.parents),
                costs=torch.where(put, (take(tree.costs, nearest) + step)[..., None], tree.costs),
                active=tree.active | put,
                count=tree.count + ok.to(torch.int64))
    return tree, idx, ok


def _select(cond, a, b):
    """Tree a where cond [...], else tree b."""
    pick = lambda x, y: torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())),  # noqa: E731
                                    x, y)
    return Tree(*(pick(x, y) for x, y in zip(_fields(a), _fields(b))))


def _fields(tree):
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def rrt_connect_plan(generator, start, goal, obstacles, radii, cfg: RRTConfig = RRTConfig(),
                     greedy_connect: bool = True, draws=None, dtype=None, device=None):
    """RRT-Connect (rrt_connect.rs): trees rooted at start and goal.
    Iteration i extends tree i % 2 toward lo + draws[..., i, :] · (hi − lo)
    (draws [..., max_nodes − 1, 2]), then the other tree extends toward the
    new node up to 8 times while each extend succeeds (CONNECT;
    `greedy_connect=False` gives one extend a side, bidirectional_rrt.rs).
    Returns (trees, link, cost): a Tree with axis −3/−2 of size 2 (tree 0
    roots at start), link = (node in tree 0, node in tree 1, gap cost)."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    n = cfg.max_nodes
    lo, hi = area(cfg, start.dtype, start.device)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = _rand(generator, batch + (n - 1, 2), start)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    trees = [init_tree(start.expand(batch + (2,)), n), init_tree(goal.expand(batch + (2,)), n)]
    zero = torch.zeros(batch, dtype=torch.int64, device=start.device)
    link = [zero, zero, torch.full(batch, BIG, dtype=start.dtype, device=start.device)]
    for i in range(n - 1):
        t, o = i % 2, 1 - i % 2
        sample = mul_add(draws[..., i, :], hi - lo, lo)
        trees[t], idx_t, ok_t = _extend(trees[t], sample, obstacles, radii, cfg)
        new_pt = take_rows(trees[t].nodes, idx_t)
        idx_o, cont = zero, ok_t
        for _ in range(8 if greedy_connect else 1):
            grown, idx2, ok2 = _extend(trees[o], new_pt, obstacles, radii, cfg)
            cont = cont & ok2
            trees[o] = _select(cont, grown, trees[o])
            idx_o = torch.where(cont, idx2, idx_o)
        o_pt = take_rows(trees[o].nodes, idx_o)
        gap = norm2(o_pt - new_pt)
        joined = (ok_t & take(trees[o].active, idx_o) & (gap <= cfg.expand_dis)
                  & edge_collision_free(o_pt, new_pt, obstacles, radii, cfg.edge_checks))
        total = take(trees[t].costs, idx_t) + take(trees[o].costs, idx_o) + gap
        better = joined & (total < link[2])
        node_a, node_b = (idx_t, idx_o) if t == 0 else (idx_o, idx_t)
        link = [torch.where(better, node_a, link[0]), torch.where(better, node_b, link[1]),
                torch.where(better, total, link[2])]
    stacked = Tree(*(torch.stack([a, b], len(batch)) for a, b in
                     zip(_fields(trees[0]), _fields(trees[1]))))
    return stacked, tuple(link), link[2]


def bidirectional_rrt_plan(generator, start, goal, obstacles, radii, cfg: RRTConfig = RRTConfig(),
                           draws=None, dtype=None, device=None):
    """Bidirectional RRT (bidirectional_rrt.rs): RRT-Connect without the
    greedy connect loop."""
    return rrt_connect_plan(generator, start, goal, obstacles, radii, cfg, False, draws, dtype,
                            device)


# ---------------------------------------------------------------------------
# graph planners: min-plus relaxation over r-disk graphs


def _edge_cost_matrix(nodes, active, radius, obstacles, radii, checks):
    """The masked symmetric [..., N, N] edge costs of the r-disk graph:
    finite where both ends are active, within radius and the edge is free."""
    n = nodes.shape[-2]
    diff = nodes[..., :, None, :] - nodes[..., None, :, :]
    dist = norm2(diff)
    pair_ok = active[..., :, None] & active[..., None, :] & (dist <= radius)
    pair_ok = pair_ok & ~torch.eye(n, dtype=torch.bool, device=nodes.device)
    t = linspace(1.0, checks, dtype=nodes.dtype, device=nodes.device)
    pts = nodes[..., :, None, None, :] + t[:, None] * (-diff)[..., None, :]  # [..., N, N, S, 2]
    d = norm2(pts[..., None, :] - obstacles)  # [..., N, N, S, M]
    free = torch.all((d > radii).flatten(-2), dim=-1)
    return torch.where(pair_ok & free, dist, BIG)


def graph_shortest_path(w, src, iters: int | None = None):
    """Single-source shortest-path costs [..., N] over a dense masked cost
    matrix w [..., N, N] by iterated min-plus relaxation D_i = min(D_i,
    min_j D_j + w[j, i]), at most `iters` (default N) relaxations or until
    none lowers a cost; the flag is read once every READ_EVERY
    relaxations (a relaxation of a converged D changes nothing)."""
    n = w.shape[-1]
    iters = n if iters is None else iters
    d = torch.where(torch.arange(n, device=w.device) == src, torch.zeros((), dtype=w.dtype,
                                                                         device=w.device), BIG)
    d = d.expand(w.shape[:-1])
    for it in range(iters):
        new = torch.minimum(d, torch.amin(d[..., :, None] + w, dim=-2))
        changed = torch.any(new < d)
        d = new
        if (it + 1) % READ_EVERY == 0 and not bool(changed):
            break
    return d


def extract_graph_path(w, costs, src, dst, max_len: int = 128):
    """Walk dst → src by greedy predecessor descent, pred(i) = argmin_j
    costs_j + w[j, i]: (indices [..., L], mask [..., L]) ordered src → dst,
    padding last."""
    cur = torch.as_tensor(dst, device=w.device).to(torch.int64).expand(costs.shape[:-1])
    done = torch.zeros_like(cur, dtype=torch.bool)
    wt = w.transpose(-1, -2)  # wt[..., i, j] = w[..., j, i]
    out = []
    for _ in range(max_len):
        col = torch.gather(wt, -2, cur[..., None, None].expand(cur.shape + (1, w.shape[-1])))
        pred = torch.argmin(costs + col[..., 0, :], dim=-1)
        out.append(torch.where(done, -1, cur))
        done = done | (cur == src)
        cur = torch.where(done, cur, pred)
    idxs = torch.stack(out, -1)
    mask = idxs >= 0
    ar = torch.arange(max_len, device=w.device)
    order = torch.argsort(torch.where(mask, -ar, max_len), dim=-1, stable=True)
    return (torch.gather(torch.where(mask, idxs, 0), -1, order), torch.gather(mask, -1, order))


@dataclasses.dataclass(frozen=True)
class GraphPlannerConfig:
    """fmt_star.rs / rrg.rs / batch_informed_rrt_star.rs surface."""

    num_samples: int = 256
    connect_radius: float = 1.5
    edge_checks: int = 8
    area_min: tuple = (-2.0, -2.0)
    area_max: tuple = (12.0, 12.0)
    batches: int = 4  # BIT* only
    batch_size: int = 64  # BIT* only


def _points_free(pts, obstacles, radii):
    return torch.all(norm2(pts[..., :, None, :] - obstacles) > radii, dim=-1)


def fmt_star_plan(generator, start, goal, obstacles, radii,
                  cfg: GraphPlannerConfig = GraphPlannerConfig(), draws=None, dtype=None,
                  device=None):
    """FMT* (fmt_star.rs): one batch of free-space samples lo + draws ·
    (hi − lo) (draws [..., num_samples, 2]) with start and goal; the
    optimal cost-to-come over the r-disk graph (the min-plus fixpoint gives
    the costs the reference's heap expansion does on the same graph).
    Returns (nodes, path indices, path mask, cost)."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    lo, hi = area(cfg, start.dtype, start.device)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = _rand(generator, batch + (cfg.num_samples, 2), start)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    pts = lo + draws * (hi - lo)
    nodes = torch.cat([start.expand(batch + (2,))[..., None, :],
                       goal.expand(batch + (2,))[..., None, :], pts.expand(batch + pts.shape[-2:])],
                      -2)
    ends = torch.ones(batch + (2,), dtype=torch.bool, device=start.device)
    active = torch.cat([ends, _points_free(pts, obstacles, radii).expand(batch + pts.shape[-2:-1])],
                       -1)
    w = _edge_cost_matrix(nodes, active, cfg.connect_radius, obstacles, radii, cfg.edge_checks)
    costs = graph_shortest_path(w, 0)
    idx, mask = extract_graph_path(w, costs, 0, 1)
    return nodes, idx, mask, costs[..., 1]


def rrg_plan(generator, start, goal, obstacles, radii, cfg: RRTConfig = RRTConfig(), draws=None,
             dtype=None, device=None):
    """RRG (rrg.rs): grow an RRT (`rrt_plan`'s draws), then answer the
    query over the r-disk graph of its nodes and the goal. Returns (nodes,
    path indices, path mask, cost)."""
    tree, _, _ = rrt_plan(generator, start, goal, obstacles, radii, cfg, False, draws, dtype,
                          device)
    f, dev = tree.nodes.dtype, tree.nodes.device
    goal = torch.as_tensor(goal, device=dev).to(f).expand(tree.nodes.shape[:-2] + (2,))
    nodes = torch.cat([tree.nodes, goal[..., None, :]], -2)
    active = torch.cat([tree.active, torch.ones_like(tree.active[..., :1])], -1)
    obstacles, radii = (torch.as_tensor(v, device=dev).to(f) for v in (obstacles, radii))
    w = _edge_cost_matrix(nodes, active, cfg.connect_radius, obstacles, radii, cfg.edge_checks)
    costs = graph_shortest_path(w, 0)
    g = nodes.shape[-2] - 1
    idx, mask = extract_graph_path(w, costs, 0, g)
    return nodes, idx, mask, costs[..., g]


def bit_star_plan(generator, start, goal, obstacles, radii,
                  cfg: GraphPlannerConfig = GraphPlannerConfig(), draws=None, dtype=None,
                  device=None):
    """BIT* (batch_informed_rrt_star.rs): anytime batches of informed
    samples over an implicit edge graph. Capacity 2 + batches·batch_size;
    batch b activates `sample_informed(draws[..., b, k, :])` (draws [...,
    batches, batch_size, 4]) drawn in the current solution ellipse,
    rebuilds the edge matrix and re-relaxes, so the cost never rises.
    Returns (nodes, path indices, path mask, cost, the cost after each
    batch)."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    f, dev = start.dtype, start.device
    lo, hi = area(cfg, f, dev)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = _rand(generator, batch + (cfg.batches, cfg.batch_size, 4), start)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-3])
    start, goal = start.expand(batch + (2,)), goal.expand(batch + (2,))
    cap = 2 + cfg.batches * cfg.batch_size
    slots = torch.arange(cap, device=dev)
    nodes = torch.where((slots == 0)[:, None], start[..., None, :],
                        torch.where((slots == 1)[:, None], goal[..., None, :], 0.0))
    active = (slots < 2).expand(batch + (cap,))
    c_best = torch.full(batch, BIG, dtype=f, device=dev)
    history = []
    for b in range(cfg.batches):
        new = sample_informed(draws[..., b, :, :], start[..., None, :], goal[..., None, :],
                              c_best[..., None], lo, hi)
        ok = _points_free(new, obstacles, radii)
        first = 2 + b * cfg.batch_size
        nodes = torch.cat([nodes[..., :first, :], new, nodes[..., first + cfg.batch_size:, :]], -2)
        active = torch.cat([active[..., :first], ok, active[..., first + cfg.batch_size:]], -1)
        w = _edge_cost_matrix(nodes, active, cfg.connect_radius, obstacles, radii,
                              cfg.edge_checks)
        c_best = torch.minimum(c_best, graph_shortest_path(w, 0)[..., 1])
        history.append(c_best)
    w = _edge_cost_matrix(nodes, active, cfg.connect_radius, obstacles, radii, cfg.edge_checks)
    costs = graph_shortest_path(w, 0)
    idx, mask = extract_graph_path(w, costs, 0, 1)
    return nodes, idx, mask, costs[..., 1], torch.stack(history, -1)


# ---------------------------------------------------------------------------
# low-discrepancy sampling (rrt_sobol.rs)


def sobol_sequence_2d(n: int, dtype=None, device=None):
    """The first n points [n, 2] of the 2D Sobol sequence in [0, 1)².

    Dim 0 is van der Corput base 2; dim 1 uses the degree-1 primitive
    polynomial x + 1 with initial direction number m1 = 1 (the standard
    Sobol dimension 2). Gray-code bit arithmetic on int64 lanes holding
    30-bit values: exact, the same bits as uint32 lanes."""
    dev = resolve_device(device)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    bits = 30
    k = torch.arange(bits, device=dev)
    v0 = torch.bitwise_left_shift(torch.ones_like(k), bits - 1 - k)
    v1, v = [], torch.full((), 1 << (bits - 1), dtype=torch.int64, device=dev)
    for _ in range(bits):  # v_k = v_{k-1} ^ (v_{k-1} >> 1)
        v1.append(v)
        v = torch.bitwise_xor(v, torch.bitwise_right_shift(v, 1))
    v1 = torch.stack(v1)
    i = torch.arange(1, n + 1, device=dev)
    g = torch.bitwise_xor(i, torch.bitwise_right_shift(i, 1))  # Gray code
    x0, x1 = torch.zeros_like(i), torch.zeros_like(i)
    for b in range(bits):
        on = torch.bitwise_and(torch.bitwise_right_shift(g, b), 1) == 1
        x0 = torch.bitwise_xor(x0, torch.where(on, v0[b], 0))
        x1 = torch.bitwise_xor(x1, torch.where(on, v1[b], 0))
    scale = 1.0 / (1 << bits)
    return torch.stack([x0.to(dtype) * scale, x1.to(dtype) * scale], -1)


def rrt_sobol_plan(start, goal, obstacles, radii, cfg: RRTConfig = RRTConfig(), star: bool = False,
                   dtype=None, device=None):
    """RRT driven by the Sobol sequence (rrt_sobol.rs): `rrt_plan`'s grow
    loop with low-discrepancy samples, the goal every
    round(1/goal_sample_rate) samples, a parent chosen (RRT*) but no
    rewire. Deterministic. Returns (Tree, best, cost)."""
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    n = cfg.max_nodes
    lo, hi = area(cfg, start.dtype, start.device)
    sob = sobol_sequence_2d(n, start.dtype, start.device)
    period = max(int(round(1.0 / max(cfg.goal_sample_rate, 1e-9))), 1)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
    start, goal = start.expand(batch + (2,)), goal.expand(batch + (2,))
    tree = init_tree(start, n)
    for i in range(n - 1):
        sample = goal if i % period == 0 else mul_add(sob[i], hi - lo, lo).expand(goal.shape)
        nearest, near_pt, new_pt, step = _steer(tree, sample, cfg.expand_dis)
        ok = edge_collision_free(near_pt, new_pt, obstacles, radii, cfg.edge_checks)
        if star:
            parent, new_cost, _, _, _ = choose_parent(tree, new_pt, obstacles, radii, cfg)
            ok = ok & (new_cost < BIG)
        else:
            parent, new_cost = nearest, take(tree.costs, nearest) + step
        tree = insert(tree, ok, new_pt, parent, new_cost)
    best, total = goal_anchor(tree, goal, cfg)
    return tree, best, total


# ---------------------------------------------------------------------------
# stochastic shortcutting (rrt_path_smoothing.rs)


def shortcut_path(generator, pts, mask, obstacles, radii, iters: int = 64,
                  edge_checks: int = 16, draws=None):
    """Random shortcutting of a padded path pts [..., n, 2]
    (rrt_path_smoothing.rs): iteration k ranks two kept waypoints by
    draws[..., k, :] (draws [..., iters, 2]) and, if the segment between
    them is free, drops the waypoints between. Points stay in place; the
    keep-mask shrinks. Returns (pts, keep, length over the kept points)."""
    n = pts.shape[-2]
    f, dev = pts.dtype, pts.device
    obstacles, radii = (torch.as_tensor(v, device=dev).to(f) for v in (obstacles, radii))
    if draws is None:
        draws = _rand(generator, pts.shape[:-2] + (iters, 2), pts)
    batch = torch.broadcast_shapes(pts.shape[:-2], mask.shape[:-1], draws.shape[:-2])
    pts = pts.expand(batch + (n, 2))
    keep = torch.as_tensor(mask, device=dev).to(torch.bool).expand(batch + (n,))
    ar = torch.arange(n, device=dev)
    for k in range(iters):
        u = draws[..., k, :]
        nk = torch.sum(keep, -1)
        r = torch.floor(u * nk[..., None].to(f)).to(torch.int64)
        r = torch.sort(r, -1).values
        order = torch.argsort(torch.where(keep, ar, n + ar), dim=-1)
        i, j = take(order, r[..., 0]), take(order, r[..., 1])
        ok = (j > i + 1) & edge_collision_free(take_rows(pts, i), take_rows(pts, j), obstacles,
                                               radii, edge_checks)
        interior = (ar > i[..., None]) & (ar < j[..., None])
        keep = torch.where(ok[..., None] & interior, False, keep)
    order = torch.sort(torch.where(keep, ar, n), -1).values
    p = torch.gather(pts, -2, torch.clamp(order, max=n - 1)[..., None].expand(batch + (n, 2)))
    ok = (order[..., :-1] < n) & (order[..., 1:] < n)
    length = rsum(torch.where(ok, norm2(p[..., 1:, :] - p[..., :-1, :]), 0.0), -1)
    return pts, keep, length
