"""Clustering + geometric fitting over point clouds.

The port of rust_robotics_tpu/mapping/cluster.py. Reference:
crates/rust_robotics_mapping/src/ — kmeans_clustering.rs (Lloyd
iterations), dbscan_clustering.rs (density labels), circle_fitting.rs
(algebraic least-squares circle), rectangle_fitting.rs (L-shape angle
search), normal_vector_estimation.rs (k-NN PCA normals),
point_cloud_sampling.rs (voxel / farthest-point / random sampling).

Everything is distance-matrix + segment-reduce shaped. DBSCAN's BFS is
iterated min-label propagation over the ε-adjacency, a fixpoint whose
`changed` flag is read once every `DBSCAN_READ_EVERY` iterations (a
propagation step at the fixpoint changes nothing, so the labels are the
same). FPS and the Poisson-disk scan are loops with nothing read back.
Segment sums go through `nlls/solver.py::scatter_add_` (the same sums on
every run); argmins and argmaxes take the first of equal values, and
sorts are stable, as JAX's are. Randomness comes from a `torch.Generator`,
or the draws are given.
"""

from __future__ import annotations

import math

import torch

from rust_robotics_tpu_torch._numeric import linspace, true_div
from rust_robotics_tpu_torch.nlls.solver import scatter_add_
from rust_robotics_tpu_torch.nlls.tridiag import full_fp32_matmul
from rust_robotics_tpu_torch.slam.visual_frontend import _lstsq_min_norm

# dbscan reads its fixpoint flag once every this many propagation steps
DBSCAN_READ_EVERY = 8


def _pairwise_sq(a, b):
    with full_fp32_matmul():
        return torch.sum(a**2, dim=-1, keepdim=True) + torch.sum(b**2, dim=-1) - 2.0 * a @ b.T


# ---------------------------------------------------------------------------
# k-means (kmeans_clustering.rs)
# ---------------------------------------------------------------------------

def kmeans(points, init_centers, iterations: int = 20):
    """Lloyd iterations; returns (centers [K, d], labels [N])."""
    k = init_centers.shape[0]
    ones = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
    centers = init_centers
    for _ in range(iterations):
        labels = torch.argmin(_pairwise_sq(points, centers), dim=-1)
        sums = scatter_add_(torch.zeros_like(centers), (labels,), points)
        counts = scatter_add_(torch.zeros(k, dtype=points.dtype, device=points.device),
                              (labels,), ones)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    labels = torch.argmin(_pairwise_sq(points, centers), dim=-1)
    return centers, labels


# ---------------------------------------------------------------------------
# DBSCAN (dbscan_clustering.rs)
# ---------------------------------------------------------------------------

def dbscan(points, eps, min_points):
    """Labels [N]: cluster id (smallest member index) or −1 for noise.

    Core points have ≥ min_points ε-neighbors (self included). Components
    over the core-connectivity graph form clusters; border points adopt the
    label of any core neighbor. Pointer-free min-label fixpoint.
    """
    n = points.shape[0]
    adj = _pairwise_sq(points, points) <= eps * eps  # includes self
    degree = torch.sum(adj, dim=-1)
    core = degree >= min_points
    # propagate labels only through core-core edges
    core_adj = adj & core[:, None] & core[None, :]
    labels = torch.arange(n, device=points.device).where(core, n)
    changed = True
    while changed:
        before = labels
        for _ in range(DBSCAN_READ_EVERY):
            neigh = labels[None, :].where(core_adj, n)
            labels = torch.minimum(labels, torch.amin(neigh, dim=-1))
        changed = bool(torch.any(labels < before))
    # border points: adopt min core-neighbor label
    border_lab = torch.amin(labels[None, :].where(adj & core[None, :], n), dim=-1)
    labels = torch.where(core, labels, border_lab)
    return labels.where(labels < n, -1)


# ---------------------------------------------------------------------------
# Circle fitting (circle_fitting.rs)
# ---------------------------------------------------------------------------

def fit_circle(points):
    """Algebraic (Kåsa) least-squares circle: returns (cx, cy, r). The
    least-squares solve is `jnp.linalg.lstsq`'s minimum-norm solution."""
    x, y = points[:, 0], points[:, 1]
    a = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    b = x**2 + y**2
    sol = _lstsq_min_norm(a, b)
    cx, cy = sol[0] / 2.0, sol[1] / 2.0
    r = torch.sqrt(torch.clamp(sol[2] + cx**2 + cy**2, min=0.0))
    return cx, cy, r


# ---------------------------------------------------------------------------
# Rectangle (L-shape) fitting (rectangle_fitting.rs)
# ---------------------------------------------------------------------------

def fit_rectangle(points, num_angles: int = 90):
    """Search over orientations for the minimum-variance L-shape fit
    (rectangle_fitting.rs closeness criterion variant): returns
    (theta, corners [4, 2]). Vectorized over the angle grid."""
    thetas = linspace(math.pi / 2.0, num_angles, endpoint=False, dtype=points.dtype,
                      device=points.device)
    c, s = torch.cos(thetas), torch.sin(thetas)
    px, py = points[:, 0], points[:, 1]
    # projections onto the two axes per angle: [A, N]
    e1 = px[None, :] * c[:, None] + py[None, :] * s[:, None]
    e2 = (-px)[None, :] * s[:, None] + py[None, :] * c[:, None]

    def closeness(proj):
        lo = torch.amin(proj, dim=-1, keepdim=True)
        hi = torch.amax(proj, dim=-1, keepdim=True)
        d = torch.minimum(proj - lo, hi - proj)
        return -torch.sum(torch.clamp(d, min=0.01), dim=-1)

    score = closeness(e1) + closeness(e2)
    best = torch.argmax(score).reshape(1)
    th = thetas.index_select(0, best)[0]
    cb, sb = torch.cos(th), torch.sin(th)
    p1 = px * cb + py * sb
    p2 = -px * sb + py * cb
    lo1, hi1 = torch.amin(p1), torch.amax(p1)
    lo2, hi2 = torch.amin(p2), torch.amax(p2)
    corners_local = torch.stack([torch.stack([lo1, lo2]), torch.stack([hi1, lo2]),
                                 torch.stack([hi1, hi2]), torch.stack([lo1, hi2])])
    rot = torch.stack([torch.stack([cb, -sb]), torch.stack([sb, cb])])
    with full_fp32_matmul():
        return th, corners_local @ rot.T


# ---------------------------------------------------------------------------
# Normals (normal_vector_estimation.rs)
# ---------------------------------------------------------------------------

def estimate_normals(points, k: int = 8):
    """k-NN PCA normals for 3D points [N, 3] -> unit normals [N, 3]. The k
    nearest come from a stable sort, which keeps `lax.top_k`'s order among
    equal distances (the lower index first). An eigenvector's sign is
    arbitrary, in both packages."""
    d2 = _pairwise_sq(points, points)
    idx = torch.sort(d2, dim=-1, stable=True).indices[:, :k]  # [N, k] nearest (includes self)
    nbrs = points[idx]  # [N, k, 3]
    mu = true_div(torch.sum(nbrs, dim=1, keepdim=True), float(k))
    d = nbrs - mu
    cov = true_div(torch.einsum("nki,nkj->nij", d, d), float(k))
    # smallest eigenvector via eigh
    _, vecs = torch.linalg.eigh(cov)
    return vecs[..., 0]


# ---------------------------------------------------------------------------
# Point-cloud sampling (point_cloud_sampling.rs)
# ---------------------------------------------------------------------------

def voxel_sample_mask(points, voxel_size):
    """Keep-first-per-voxel mask [N] (voxel grid sampling). The int64 voxel
    hash is sorted stably, as `jnp.argsort` sorts."""
    cells = torch.floor(true_div(points, voxel_size)).to(torch.int64)
    h = cells[:, 0] * 73856093
    for j in range(1, points.shape[1]):
        h = h ^ cells[:, j] * (19349663 if j == 1 else 83492791)
    order = torch.argsort(h, stable=True)
    hs = h[order]
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool, device=h.device), hs[1:] != hs[:-1]])
    return torch.zeros(points.shape[0], dtype=torch.bool, device=h.device).index_put_(
        (order,), first_sorted)


def farthest_point_sample(points, num_samples, start: int = 0, valid=None):
    """FPS indices [num_samples] (int32) via running min-distance field.
    `valid` masks padded points out of selection (their distance is pinned
    -inf). The loop reads nothing back."""
    n = points.shape[0]
    dev = points.device
    cur = torch.full((1,), start, dtype=torch.int64, device=dev)
    idx = [cur]
    mind = torch.full((n,), torch.inf, dtype=points.dtype, device=dev)
    for _ in range(1, num_samples):
        last = points.index_select(0, cur)
        d = torch.sum((points - last) ** 2, dim=-1)
        mind = torch.minimum(mind, d)
        gated = mind if valid is None else mind.where(valid, -torch.inf)
        cur = torch.argmax(gated).reshape(1)
        idx.append(cur)
    return torch.cat(idx).to(torch.int32)


def random_sample(points, num_samples, generator=None, draws=None):
    """`num_samples` distinct indices: the first of a random permutation of
    the N points (`jax.random.choice(..., replace=False)`). `draws` = that
    permutation [N], else drawn from `generator`."""
    if draws is None:
        draws = torch.randperm(points.shape[0], generator=generator, device=points.device)
    return draws[:num_samples]


def poisson_disk_sample(points, n_points, min_distance, max_iter: int, valid=None,
                        generator=None, draws=None):
    """Poisson-disk (dart-throwing) subset mask [N]
    (point_cloud_sampling.rs:129 `poisson_disk_sampling`): start from a
    random valid point, then propose `max_iter` random candidates, accepting
    one when its distance to every already-selected point is >=
    min_distance and fewer than `n_points` are selected.

    `draws` = (first [], candidates [max_iter]) indices, else drawn from
    `generator`: the first uniformly among the valid points, the candidates
    uniformly among all N. One step a proposal, with nothing read back.
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if draws is None:
        first = torch.multinomial(valid.to(points.dtype), 1, generator=generator)[0]
        cands = torch.randint(0, n, (max_iter,), generator=generator, device=dev)
    else:
        first, cands = draws
    idx = torch.arange(n, device=dev)
    sel = idx == first
    count = torch.ones((), dtype=torch.int32, device=dev)
    for cand in cands.reshape(-1, 1):
        base = points.index_select(0, cand)
        diff = points - base
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        dmin = torch.amin(d.where(sel, torch.inf))
        ok = (dmin >= min_distance) & (count < n_points) & valid.index_select(0, cand)[0]
        sel = sel | ((idx == cand) & ok)
        count = count + ok.to(torch.int32)
    return sel
