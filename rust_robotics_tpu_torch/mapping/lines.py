"""Line extraction (split-and-merge) and IMLS surface projection.

The port of rust_robotics_tpu/mapping/lines.py. Reference
(crates/rust_robotics_mapping/src/): line_extraction.rs (308:
split-and-merge over an ordered scan), imls.rs (130: implicit moving least
squares surface distance/projection).

Split-and-merge's recursion becomes a fixed-depth iteration over a
breakpoint mask: every level computes all segment point-line distances at
once (segment max/min by `scatter_reduce_` over JAX's empty-segment
identities). The merge pass visits the interior points in order; each
visit computes its check and keeps or drops the breakpoint by a `where`,
so nothing is read back. IMLS is a weighted reduction over neighbor
points; its gradient comes from `torch.func.grad` (reverse mode).
"""

from __future__ import annotations

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import true_div


def _point_line_dist(p, a, b):
    ab = b - a
    denom = torch.clamp(torch.sqrt(ab[..., 0] ** 2 + ab[..., 1] ** 2), min=1e-9)
    cross = ab[..., 0] * (p[..., 1] - a[..., 1]) - ab[..., 1] * (p[..., 0] - a[..., 0])
    return torch.abs(cross) / denom


def _seg_bounds(breaks, idx, n):
    """For each point: indices of its segment's endpoints (running max of
    breakpoints to the left, running min to the right)."""
    left = torch.cummax(idx.where(breaks, -1), dim=0).values
    right = torch.flip(torch.cummin(torch.flip(idx.where(breaks, n), (0,)), dim=0).values, (0,))
    return left, right


def split_and_merge(points, max_depth: int = 8, split_threshold: float = 0.1,
                    merge_threshold: float = 0.08):
    """Ordered scan points [N, 2] -> breakpoint mask [N] (True = segment
    endpoint). Fixed-depth iterative splitting; adjacent segments whose
    joined fit stays tight are re-merged."""
    n = points.shape[0]
    dev = points.device
    idx = torch.arange(n, device=dev)
    breaks = (idx == 0) | (idx == n - 1)

    for _ in range(max_depth):
        left, right = _seg_bounds(breaks, idx, n)
        d = _point_line_dist(points, points[left], points[right])
        # mask out existing breakpoints; find per-segment max deviation
        d = d.where(~breaks, 0.0)
        seg_id = left  # segment key
        seg_max = torch.full((n,), -torch.inf, dtype=d.dtype, device=dev).scatter_reduce_(
            0, seg_id, d, "amax", include_self=False)
        is_max = (d >= seg_max[seg_id] - 1e-12) & (d > split_threshold)
        # one split per segment: the first max index
        first_max = torch.full((n,), torch.iinfo(torch.int64).max, device=dev).scatter_reduce_(
            0, seg_id, idx.where(is_max, n), "amin", include_self=False)
        breaks = breaks | (idx == first_max[seg_id])

    # merge pass: drop interior breakpoints whose joined segment stays tight
    for i in range(1, n - 1):
        lo = torch.amax(idx.where(breaks & (idx < i), -1)).reshape(1)
        hi = torch.amin(idx.where(breaks & (idx > i), n)).reshape(1)
        a_ = points.index_select(0, lo)
        c_ = points.index_select(0, torch.clamp(hi, 0, n - 1))
        span = (idx >= lo) & (idx <= hi)
        worst = torch.amax(_point_line_dist(points, a_, c_).where(span, 0.0))
        keep = worst > merge_threshold
        breaks = breaks.where(idx != i, breaks[i] & keep)
    return breaks


def segments_from_breaks(points, breaks):
    """Host-side: list of (start_xy, end_xy) per extracted segment."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    b = np.nonzero(host(breaks))[0]
    p = host(points)
    return [(p[b[i]], p[b[i + 1]]) for i in range(len(b) - 1)]


def imls_distance(query, points, normals, h=0.5):
    """IMLS signed distance of query [..., 2or3] to the point set
    (imls.rs): f(x) = Σ w_i (x−p_i)·n_i / Σ w_i with Gaussian weights."""
    d = query[..., None, :] - points
    r2 = torch.sum(d * d, dim=-1)
    w = torch.exp(true_div(-r2, h * h))
    num = torch.sum(w * torch.sum(d * normals, dim=-1), dim=-1)
    den = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    return num / den


def imls_project(query, points, normals, h=0.5, iterations=5):
    """Project query points onto the IMLS surface by gradient steps."""
    grad = torch.func.grad(lambda q: torch.sum(imls_distance(q[None], points, normals, h)))
    q = query
    for _ in range(iterations):
        f = imls_distance(q[None], points, normals, h)[0]
        g = grad(q)
        g = g / torch.clamp(torch.sqrt(torch.sum(g * g)), min=1e-9)
        q = q - f * g
    return q
