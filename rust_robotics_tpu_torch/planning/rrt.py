"""RRT and RRT* over fixed-capacity batched trees.

The port of rust_robotics_tpu/planning/rrt.py. Reference:
crates/rust_robotics_planning/src/ — rrt.rs (`RRTPlanner::planning` :156:
grow a tree with parent indices, steer by expand_dis, goal-sample rate,
obstacle circles), rrt_star.rs (choose-parent within connect radius and
rewiring :82).

The grown tree is a fixed-capacity node array [..., N, 2] with parents,
costs, an active mask and a count; each iteration is one masked update
with no read: nearest and near sets are masked reductions over all slots,
and each candidate edge checks its S interpolated points against every
obstacle circle at once. Leading batch dims run a forest of independent
trees in lock-step (every op is elementwise or a reduction over a tree's
own axis, so a lane equals its solo run). The samples are `draws=` (the
uniforms JAX's split keys give) or drawn from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import torch

from rust_robotics_tpu_torch._numeric import fma, linspace, norm2
from rust_robotics_tpu_torch.control._small import as_float, take, take_rows

BIG = 1e18


@dataclasses.dataclass(frozen=True)
class RRTConfig:
    """rrt.rs / rrt_star.rs config surface."""

    expand_dis: float = 0.5
    goal_sample_rate: float = 0.1
    max_nodes: int = 512
    connect_radius: float = 1.5  # RRT* near radius
    edge_checks: int = 10
    area_min: tuple = (-2.0, -2.0)
    area_max: tuple = (12.0, 12.0)
    goal_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class Tree:
    nodes: torch.Tensor  # [..., N, 2]
    parents: torch.Tensor  # [..., N] int64, -1 for none
    costs: torch.Tensor  # [..., N]
    active: torch.Tensor  # [..., N] bool
    count: torch.Tensor  # [...] int64


def mul_add(a, b, c):
    """a·b + c rounded once, as XLA contracts it inside a compiled loop
    body (JAX's grow loops are `fori_loop`s), broadcast."""
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    return fma(a.expand(shape), b.expand(shape), c.expand(shape))


def edge_collision_free(p0, p1, obstacles, radii, checks):
    """Whether the segments p0 → p1 [..., 2] clear every obstacle circle,
    `checks` samples each: [...] bool."""
    t = linspace(1.0, checks, dtype=p0.dtype, device=p0.device)[:, None]
    pts = mul_add(t, (p1 - p0)[..., None, :], p0[..., None, :])
    d = norm2(pts[..., :, None, :] - obstacles)  # [..., S, M]
    return torch.all((d > radii).flatten(-2), dim=-1)


def area(cfg, dtype, device):
    """(lo, hi) of cfg's sampling area as tensors made by fills."""
    lo = torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in cfg.area_min])
    hi = torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in cfg.area_max])
    return lo, hi


def init_tree(root, n):
    """A tree of capacity n holding only `root` [..., d] in slot 0."""
    slots = torch.arange(n, device=root.device)
    first = slots == 0
    batch = root.shape[:-1]
    nodes = torch.where(first[:, None], root[..., None, :],
                        torch.zeros(batch + (n, root.shape[-1]), dtype=root.dtype,
                                    device=root.device))
    return Tree(nodes=nodes,
                parents=torch.full(batch + (n,), -1, dtype=torch.int64, device=root.device),
                costs=torch.where(first, torch.zeros((), dtype=root.dtype, device=root.device),
                                  torch.full((), BIG, dtype=root.dtype,
                                             device=root.device)).expand(batch + (n,)),
                active=first.expand(batch + (n,)),
                count=torch.ones(batch, dtype=torch.int64, device=root.device))


def insert(tree, ok, new_pt, parent, new_cost):
    """Slot `count` takes (new_pt, parent, new_cost) where ok, else it is
    reset (parent -1, cost BIG, inactive), as rrt.py's `.at[idx].set`."""
    n = tree.parents.shape[-1]
    put = torch.arange(n, device=ok.device) == tree.count[..., None]
    okp = ok[..., None]
    return Tree(
        nodes=torch.where(put[..., None] & okp[..., None], new_pt[..., None, :], tree.nodes),
        parents=torch.where(put, torch.where(okp, parent[..., None], -1), tree.parents),
        costs=torch.where(put, torch.where(okp, new_cost[..., None], BIG), tree.costs),
        active=torch.where(put, okp, tree.active),
        count=tree.count + ok.to(torch.int64))


def _steer(tree, sample, expand_dis):
    """The nearest active node, and the point expand_dis (at most) from it
    toward `sample`: (nearest, its point, new point, step)."""
    d = torch.where(tree.active, norm2(tree.nodes - sample[..., None, :]), BIG)
    nearest = torch.argmin(d, dim=-1)
    near_pt = take_rows(tree.nodes, nearest)
    direction = sample - near_pt
    dist = torch.clamp(norm2(direction), min=1e-9)
    step = torch.clamp(dist, max=expand_dis)
    return nearest, near_pt, mul_add(direction / dist[..., None], step[..., None], near_pt), step


def choose_parent(tree, new_pt, obstacles, radii, cfg):
    """RRT*'s parent: the cheapest active node within connect_radius whose
    edge to new_pt is free. (parent, cost, dn, near, free_to)."""
    dn = norm2(tree.nodes - new_pt[..., None, :])
    near = tree.active & (dn <= cfg.connect_radius)
    free_to = edge_collision_free(tree.nodes, new_pt[..., None, :].expand(tree.nodes.shape),
                                  obstacles, radii, cfg.edge_checks)
    cand = torch.where(near & free_to, tree.costs + dn, BIG)
    parent = torch.argmin(cand, dim=-1)
    return parent, take(cand, parent), dn, near, free_to


def rewire(tree, better, idx, through):
    """Near nodes for which `better` holds take the new node (slot idx) as
    parent at cost `through`; their descendants keep their costs."""
    return dataclasses.replace(tree, parents=torch.where(better, idx[..., None], tree.parents),
                               costs=torch.where(better, through, tree.costs))


def goal_anchor(tree, goal, cfg):
    """The cheapest active node within goal_threshold of the goal, with
    its cost to the goal: (best, total)."""
    dg = norm2(tree.nodes - goal[..., None, :])
    at_goal = tree.active & (dg <= cfg.goal_threshold)
    total = torch.where(at_goal, tree.costs + dg, BIG)
    best = torch.argmin(total, dim=-1)
    return best, take(total, best)


def _inputs(start, goal, obstacles, radii, dtype, device):
    start = as_float(start, dtype, device)
    f, dev = start.dtype, start.device
    return (start, as_float(goal, f, dev), as_float(obstacles, f, dev), as_float(radii, f, dev))


def rrt_plan(generator, start, goal, obstacles, radii, cfg: RRTConfig = RRTConfig(),
             star: bool = False, draws=None, dtype=None, device=None):
    """Grow an RRT / RRT* tree; returns (Tree, best goal node, its cost).

    Iteration i samples the goal where draws[..., i, 0] < goal_sample_rate,
    else lo + draws[..., i, 1:] · (hi − lo): `draws` [..., max_nodes − 1,
    3] uniforms, else drawn from `generator`. Leading dims of start, goal
    and draws make a forest. The best node within goal_threshold of the
    goal (by cost) anchors the solution; `extract_rrt_path` walks it.
    """
    start, goal, obstacles, radii = _inputs(start, goal, obstacles, radii, dtype, device)
    n = cfg.max_nodes
    f, dev = start.dtype, start.device
    lo, hi = area(cfg, f, dev)
    if draws is None:
        batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1])
        draws = torch.rand(batch + (n - 1, 3), generator=generator, dtype=f, device=dev)
    batch = torch.broadcast_shapes(start.shape[:-1], goal.shape[:-1], draws.shape[:-2])
    start, goal = start.expand(batch + (2,)), goal.expand(batch + (2,))
    tree = init_tree(start, n)
    for i in range(n - 1):
        u = draws[..., i, :]
        sample = torch.where(u[..., :1] < cfg.goal_sample_rate, goal,
                             mul_add(u[..., 1:], hi - lo, lo))
        nearest, near_pt, new_pt, step = _steer(tree, sample, cfg.expand_dis)
        ok = edge_collision_free(near_pt, new_pt, obstacles, radii, cfg.edge_checks)
        idx = tree.count
        if star:
            parent, new_cost, _, _, _ = choose_parent(tree, new_pt, obstacles, radii, cfg)
            ok = ok & (new_cost < BIG)
            parent = torch.where(ok, parent, nearest)
            new_cost = torch.where(ok, new_cost, BIG)
        else:
            parent, new_cost = nearest, take(tree.costs, nearest) + step
        tree = insert(tree, ok, new_pt, parent, new_cost)
        if star:
            # rewire the near nodes through the new node
            dn = norm2(tree.nodes - new_pt[..., None, :])
            through = new_cost[..., None] + dn
            near = tree.active & (dn <= cfg.connect_radius)
            free_to = edge_collision_free(new_pt[..., None, :].expand(tree.nodes.shape),
                                          tree.nodes, obstacles, radii, cfg.edge_checks)
            better = ok[..., None] & near & free_to & (through < tree.costs)
            tree = rewire(tree, better, idx, through)
    best, total = goal_anchor(tree, goal, cfg)
    return tree, best, total


def walk_parents(parents, node, max_len):
    """Indices [..., max_len] from `node` up the parent links to the root,
    then -1."""
    cur = node
    done = torch.zeros_like(node, dtype=torch.bool)
    out = []
    for _ in range(max_len):
        nxt = take(parents, cur)
        out.append(torch.where(done, -1, cur))
        done = done | (nxt < 0)
        cur = torch.where(done, cur, nxt)
    return torch.stack(out, -1)


def extract_rrt_path(tree: Tree, node, max_len: int = 256):
    """Walk parent links from `node` to the root: (points [..., L, 2],
    mask [..., L]) with the root last."""
    node = torch.as_tensor(node, device=tree.parents.device).to(torch.int64)
    idxs = walk_parents(tree.parents, node, max_len)
    pts = torch.gather(tree.nodes.expand(idxs.shape[:-1] + tree.nodes.shape[-2:]), -2,
                       torch.clamp(idxs, min=0)[..., None].expand(idxs.shape + (2,)))
    return pts, idxs >= 0
