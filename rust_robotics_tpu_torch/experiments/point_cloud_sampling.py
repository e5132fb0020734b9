"""Point-cloud sampling quality experiment suite.

The port of rust_robotics_tpu/experiments/point_cloud_sampling.py.
Reference: crates/rust_robotics_mapping/src/experiments/
point_cloud_sampling_quality/ (mod.rs + 5 variant files, ~1,418 LoC):
scenario *families* built from three synthetic cloud kinds (LayeredPlane,
TwinClusterBridge, RingWithOutliers; mod.rs:44-48) with structured
corruptions (SlabDrop / DensityShift / SectorDrop; mod.rs:50-70), six
process problems (mod.rs:174-487), three samplers compared per cloud
(voxel grid over a spacing-factor sweep, farthest-point, Poisson disk over
a min-distance sweep; mod.rs:1071-1106), a composite quality score
(coverage + 0.25·support + 0.45·count-error + 0.12/spacing +
0.08·centroid; mod.rs:1108-1129, lower is better), and five aggregation
*variants* that pick scenario slots per (family, bucket) (mod.rs:503-:704).

Every scenario slot of a (case, bucket) cell is a fixed-shape [P, 3] cloud
with a validity mask, and the slots are lanes of one batch: the clouds
generate together, the three samplers (`mapping/cluster.py`, over leading
batch dims) select subset masks with the factor sweeps as lanes too
(slots × 5 voxel sizes, slots × 6 Poisson distances), and the score's
nearest-distance terms share one [slots, P, P] distance matrix. The
randomness of a cell (JAX: the splits of a key folded with the family's
CRC32 and the bucket) is given as `draws=` (`CellDraws`, one entry per
split, one row a slot) or drawn from a `torch.Generator`. The aggregation
variants index the [slots, 3] score table on the host.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import filled, true_div
from rust_robotics_tpu_torch.mapping.cluster import (
    farthest_point_sample,
    poisson_disk_sample,
    voxel_sample_mask,
)
from rust_robotics_tpu_torch.utils.experiments import VariantDescriptor

__all__ = [
    "CloudCase", "PointSamplingObservation", "PROCESS_PROBLEMS", "CellDraws",
    "score_sample_quality", "slot_scores_for_cell",
    "run_point_cloud_sampling_quality", "AGGREGATION_VARIANTS",
]

_METHODS = ("Voxel", "FarthestPoint", "PoissonDisk")
_VOXEL_FACTORS = (0.35, 0.55, 0.85, 1.30, 2.0)
_POISSON_FACTORS = (0.10, 0.20, 0.35, 0.60, 1.0, 1.45)


@dataclasses.dataclass(frozen=True)
class CloudCase:
    """mod.rs:74-87 PointSamplingExperimentCase analog (corruption params
    flattened; `kind` ∈ layered_plane|twin_cluster|ring)."""

    family_name: str
    buckets: Tuple[int, ...]
    base_point_count: int = 192
    kind: str = "layered_plane"
    base_jitter_scale: float = 0.08
    base_outlier_fraction: float = 0.04
    extra_noise_scales: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    corruption: str = "none"  # none|slab_drop|density_shift|sector_drop
    corruption_axis: int = 0
    corruption_center: float = 0.0
    corruption_half_width: float = 3.0
    drop_probability: float = 0.0
    dense_duplicate_probability: float = 0.0
    sparse_keep_probability: float = 1.0
    sector_start: float = 0.0
    sector_end: float = 0.0
    burst_slots: Tuple[int, ...] = ()
    burst_noise_scales: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    burst_outlier_multiplier: float = 1.0


def _default_problems() -> Dict[str, List[CloudCase]]:
    """The six process problems (mod.rs:174-487), one representative case
    per cloud kind where the reference enumerates several."""
    return {
        "point_cloud_sampling": [
            CloudCase("plane_baseline", (48, 96), kind="layered_plane"),
            CloudCase("ring_baseline", (48, 96), kind="ring",
                      base_outlier_fraction=0.06),
        ],
        "occlusion_corruption": [
            CloudCase("plane_slab_occlusion", (48, 96),
                      kind="layered_plane", corruption="slab_drop",
                      corruption_axis=0, corruption_center=4.0,
                      corruption_half_width=4.0, drop_probability=0.8),
            CloudCase("ring_sector_occlusion", (48, 96), kind="ring",
                      corruption="sector_drop", sector_start=0.4,
                      sector_end=1.8, drop_probability=0.9),
        ],
        "density_shift": [
            CloudCase("twin_density_shift", (48, 96), kind="twin_cluster",
                      corruption="density_shift", corruption_axis=0,
                      corruption_center=-7.0, corruption_half_width=4.0,
                      dense_duplicate_probability=0.5,
                      sparse_keep_probability=0.55),
        ],
        "anisotropic_noise": [
            CloudCase("plane_aniso", (48, 96), kind="layered_plane",
                      extra_noise_scales=(0.02, 0.3, 0.9)),
            CloudCase("twin_aniso", (48, 96), kind="twin_cluster",
                      extra_noise_scales=(0.5, 0.05, 0.4)),
        ],
        "sparse_outlier_burst": [
            CloudCase("ring_burst", (48, 96), kind="ring",
                      base_outlier_fraction=0.03, burst_slots=(2, 5, 8),
                      burst_noise_scales=(0.3, 0.3, 0.2),
                      burst_outlier_multiplier=3.0),
        ],
        "resolution_ladder": [
            CloudCase("plane_ladder", (24, 48, 96, 144),
                      kind="layered_plane"),
        ],
    }


PROCESS_PROBLEMS = _default_problems()


class CellDraws(NamedTuple):
    """The randomness of one (case, bucket) cell, one row a slot (JAX's
    splits, in order): `structure` [S, n, 3] uniforms of the cloud kind
    (twin cluster in [−1, 1), ring in [0, 1); None for the layered plane),
    `jitter` and `extra` [S, n, 3] standard normals, `drop` [S, n]
    uniforms, `outliers` [S, n_out, 3] uniforms in [−1, 1), for a density
    shift `dup_src` [S, n_out] indices in [0, n) and `dup_noise` [S, n_out,
    3] normals (else None), and the Poisson sampler's `poisson_first`
    [S, 6] (None: drawn among the valid points) and `poisson_cands` [S, 6,
    max_iter] indices."""

    structure: Optional[torch.Tensor]
    jitter: torch.Tensor
    extra: torch.Tensor
    drop: torch.Tensor
    outliers: torch.Tensor
    dup_src: Optional[torch.Tensor]
    dup_noise: Optional[torch.Tensor]
    poisson_first: Optional[torch.Tensor]
    poisson_cands: torch.Tensor


def _n_out_max(case: CloudCase) -> int:
    n = case.base_point_count
    return max(int(n * case.base_outlier_fraction * case.burst_outlier_multiplier * 2.5), 4)


def cloud_size(case: CloudCase) -> int:
    """P: the structure points plus the outlier slots of a cloud."""
    return case.base_point_count + _n_out_max(case)


def draw_cell(generator, case: CloudCase, n_slots: int, max_iter: int, dtype=torch.float32,
              device=None) -> CellDraws:
    """A cell's `CellDraws` from a `torch.Generator` on `device`."""
    n, n_out = case.base_point_count, _n_out_max(case)
    kw = dict(generator=generator, dtype=dtype, device=device)
    structure = None
    if case.kind == "twin_cluster":
        structure = torch.rand((n_slots, n, 3), **kw) * 2.0 - 1.0
    elif case.kind == "ring":
        structure = torch.rand((n_slots, n, 3), **kw)
    dense = case.corruption == "density_shift"
    return CellDraws(
        structure, torch.randn((n_slots, n, 3), **kw), torch.randn((n_slots, n, 3), **kw),
        torch.rand((n_slots, n), **kw), torch.rand((n_slots, n_out, 3), **kw) * 2.0 - 1.0,
        torch.randint(0, n, (n_slots, n_out), generator=generator, device=device)
        if dense else None,
        torch.randn((n_slots, n_out, 3), **kw) if dense else None, None,
        torch.randint(0, cloud_size(case), (n_slots, len(_POISSON_FACTORS), max_iter),
                      generator=generator, device=device))


# ---------------------------------------------------------------------------
# Cloud generation (mod.rs:705-:900) — fixed-shape, mask-valid
# ---------------------------------------------------------------------------

def _gen_structure(kind: str, n: int, jitter, phase, u, noise):
    """Structured points [S, n, 3] for one cloud kind; jitter and phase
    [S], u the kind's uniforms, noise [S, n, 3] normals."""
    dtype, dev = noise.dtype, noise.device
    i = torch.arange(n, device=dev)
    ph = phase[:, None]
    if kind == "layered_plane":
        side = max(int(np.sqrt(n / 2)), 2)
        layer, rem = i // (side * side), i % (side * side)
        ix, iy = (rem // side).to(dtype), (rem % side).to(dtype)
        x = (-12.0 + true_div(24.0 * ix, max(side - 1, 1))).expand(len(phase), n)
        y = (-12.0 + true_div(24.0 * iy, max(side - 1, 1))).expand(len(phase), n)
        z = layer.to(dtype) * 1.8 + 0.25 * torch.sin(0.22 * x + ph)
        pts = torch.stack([x, y, z], -1)
    elif kind == "twin_cluster":
        nb = n // 6
        nc = (n - nb) // 2
        left = torch.stack([-7.0 + 2.4 * u[..., 0], -2.0 + 2.6 * u[..., 1],
                            1.0 + 1.5 * u[..., 2]], -1)
        right = torch.stack([7.0 + 2.2 * u[..., 0], 2.0 + 2.3 * u[..., 1],
                             -0.8 + 1.3 * u[..., 2]], -1)
        t = torch.clamp(true_div((i - 2 * nc).to(dtype), max(nb - 1, 1)), 0.0, 1.0)
        bridge = torch.stack([(-4.5 + 9.0 * t).expand(len(phase), n),
                              1.4 * torch.sin(2 * math.pi * t + ph),
                              0.9 * torch.cos(math.pi * t + 0.5 * ph)], -1)
        pts = torch.where((i < nc)[:, None], left,
                          torch.where((i < 2 * nc)[:, None], right, bridge))
    elif kind == "ring":
        nr = n * 3 // 4
        t = true_div(i.to(dtype), max(nr, 1))
        theta = 2 * math.pi * t
        radius = 8.0 + 1.2 * torch.sin(5 * theta + ph)
        ring = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                            1.5 * torch.cos(0.5 * theta + ph)], -1)
        th = 2 * math.pi * u[..., 0]
        rr = 3.0 * u[..., 1]
        core = torch.stack([rr * torch.cos(th), rr * torch.sin(th), -1.5 + 3.0 * u[..., 2]], -1)
        pts = torch.where((i < nr)[:, None], ring, core)
    else:
        raise ValueError(f"unknown cloud kind {kind!r}")
    return pts + jitter[:, None, None] * noise


def _generate_cell_clouds(case: CloudCase, bucket: int, draws: CellDraws):
    """All scenario-slot clouds of one (case, bucket) cell: (points [S, P,
    3], valid [S, P]) with P = structure + outlier slots."""
    n, n_out = case.base_point_count, _n_out_max(case)
    s = draws.jitter.shape[0]
    dtype, dev = draws.jitter.dtype, draws.jitter.device
    slot = torch.arange(s, dtype=dtype, device=dev)
    bursts = [k in case.burst_slots for k in range(s)]
    burst = torch.zeros(s, dtype=torch.bool, device=dev)
    for k in case.burst_slots:
        if k < s:
            burst[k] = True
    jitter = (case.base_jitter_scale * (1.0 + bucket / 260.0) * (1.0 + true_div(slot, 40.0))
              * torch.where(burst, torch.full((), 1.10 + bucket / 900.0, dtype=dtype, device=dev),
                            1.0))
    phase = slot * 0.17
    pts = _gen_structure(case.kind, n, jitter, phase, draws.structure, draws.jitter)
    # per-axis extra noise (anisotropic family); bursts add more
    scales = filled(case.extra_noise_scales, dtype, dev) + torch.where(
        burst[:, None], filled(case.burst_noise_scales, dtype, dev), 0.0)
    pts = pts + scales[:, None, :] * draws.extra

    valid = torch.ones((s, n), dtype=torch.bool, device=dev)
    u = draws.drop
    axis = case.corruption_axis
    if case.corruption == "slab_drop":
        inside = torch.abs(pts[..., axis] - case.corruption_center) < case.corruption_half_width
        valid &= ~(inside & (u < case.drop_probability))
    elif case.corruption == "sector_drop":
        ang = torch.remainder(torch.atan2(pts[..., 1], pts[..., 0]), 2 * math.pi)
        inside = (ang > case.sector_start) & (ang < case.sector_end)
        valid &= ~(inside & (u < case.drop_probability))
    elif case.corruption == "density_shift":
        inside = torch.abs(pts[..., axis] - case.corruption_center) < case.corruption_half_width
        # sparse side: keep with probability sparse_keep_probability;
        # dense side: duplicates land in the outlier slot budget below
        valid &= inside | (u < case.sparse_keep_probability)

    # uniform outliers, count scaled by bucket (mod.rs:732-:735)
    base = n * case.base_outlier_fraction * (0.6 + bucket / 300.0)
    n_outliers = [int(np.round(base * (case.burst_outlier_multiplier if b else 1.0)))
                  for b in bursts]
    extra = draws.outliers * filled((18.0, 18.0, 6.0), dtype, dev)
    if case.corruption == "density_shift":
        # dense-region duplicates instead of pure outliers
        src = draws.dup_src.to(device=dev, dtype=torch.int64)
        dup = torch.gather(pts, 1, src[..., None].expand(s, n_out, 3)) + 0.05 * draws.dup_noise
        inside_src = torch.abs(dup[..., axis] - case.corruption_center) < case.corruption_half_width
        n_dup = int(np.round(n * case.dense_duplicate_probability * 0.2))
        extra = torch.where(inside_src[..., None], dup, extra)
        n_outliers = [max(k, n_dup) for k in n_outliers]
    counts = filled(n_outliers, torch.int64, dev)
    extra_valid = torch.arange(n_out, device=dev) < counts[:, None]
    return torch.cat([pts, extra], 1), torch.cat([valid, extra_valid], 1)


# ---------------------------------------------------------------------------
# Scoring (mod.rs:1071-:1199) — masked distance matrices
# ---------------------------------------------------------------------------

def _distances(points):
    """[..., P, P] distances between the points of each cloud [..., P, 3]."""
    diff = points[..., :, None, :] - points[..., None, :, :]
    return torch.sqrt(torch.sum(diff * diff, -1))


def _masked_nn_mean(d, a_mask, b_mask):
    """Mean over masked a of the min distance d [..., A, B] to masked b."""
    nn = torch.amin(torch.where(b_mask[..., None, :], d, torch.inf), dim=-1)
    return (torch.sum(torch.where(a_mask, nn, 0.0), -1)
            / torch.clamp(torch.sum(a_mask, -1), min=1))


def score_sample_quality(points, valid, sel, target_count, distances=None):
    """Composite sampler-quality score (mod.rs:1108 `score_sample_quality`,
    lower is better): coverage + 0.25·support + 0.45·count-error +
    0.12/spacing + 0.08·centroid; `sel` [..., P] is the selected-subset
    mask of the cloud points [..., P, 3] (`distances`: its [..., P, P]
    distance matrix, if already at hand)."""
    d = _distances(points) if distances is None else distances
    n_sel = torch.sum(sel, -1)
    coverage = _masked_nn_mean(d, valid, sel)
    support = _masked_nn_mean(d, sel, valid)
    p = points.shape[-2]
    off = sel[..., None, :] & ~torch.eye(p, dtype=torch.bool, device=points.device)
    nn = torch.amin(torch.where(off, d, torch.inf), dim=-1)
    spacing = torch.sum(torch.where(sel, nn, 0.0), -1) / torch.clamp(n_sel, min=1)
    spacing = torch.where(n_sel <= 1, 1e-6, spacing)
    count_err = true_div(torch.abs(n_sel.to(points.dtype) - target_count), max(target_count, 1))
    cen_o = (torch.sum(torch.where(valid[..., None], points, 0.0), -2)
             / torch.clamp(torch.sum(valid, -1), min=1)[..., None])
    cen_s = (torch.sum(torch.where(sel[..., None], points, 0.0), -2)
             / torch.clamp(n_sel, min=1)[..., None])
    centroid = torch.linalg.vector_norm(cen_o - cen_s, dim=-1)
    score = (coverage + 0.25 * support + 0.45 * count_err
             + 0.12 / torch.clamp(spacing, min=1e-6) + 0.08 * centroid)
    return torch.where(n_sel == 0, torch.inf, score)


def _characteristic_spacing(points, valid, target_count):
    """Bounding-box extent / target^(1/3) (mod.rs:1188), per cloud."""
    big = 1e9
    mn = torch.amin(torch.where(valid[..., None], points, big), -2)
    mx = torch.amax(torch.where(valid[..., None], points, -big), -2)
    extent = torch.clamp(torch.linalg.vector_norm(mx - mn, dim=-1), min=1e-3)
    return true_div(extent, max(max(target_count, 1.0) ** (1 / 3), 1.0))


def _score_clouds(points, valid, target_count: int, max_iter: int, draws: CellDraws,
                  generator=None):
    """[S, 3] (voxel, fps, poisson) best scores of the clouds [S, P, 3]:
    the slot-cache entries (mod.rs:756 `build_slot_sample_cache`); the
    factor sweeps are lanes."""
    s, p = points.shape[:2]
    dtype, dev = points.dtype, points.device
    d = _distances(points)[:, None]  # [S, 1, P, P], shared by every selection
    spacing = _characteristic_spacing(points, valid, float(target_count))
    far = points + torch.where(valid[..., None], 0.0, torch.full((), 1e6, dtype=dtype,
                                                                 device=dev))  # exile invalid

    def best(sel, factors):
        lanes = (s, len(factors), p)
        return torch.amin(score_sample_quality(points[:, None].expand(lanes + (3,)),
                                               valid[:, None].expand(lanes), sel, target_count,
                                               d.expand(lanes + (p,))), -1)

    vox_f = filled(_VOXEL_FACTORS, dtype, dev)
    sizes = torch.clamp(spacing[:, None] * vox_f, min=1e-4)
    sel_v = voxel_sample_mask(far[:, None].expand(s, len(_VOXEL_FACTORS), p, 3), sizes)
    vox = best(sel_v & valid[:, None], _VOXEL_FACTORS)

    idx = farthest_point_sample(points, target_count, valid=valid).to(torch.int64)
    sel_f = torch.zeros((s, p), dtype=torch.bool, device=dev).scatter(-1, idx, True) & valid
    fps = score_sample_quality(points, valid, sel_f, target_count, d[:, 0])

    poi_f = filled(_POISSON_FACTORS, dtype, dev)
    lanes = (s, len(_POISSON_FACTORS))
    first = draws.poisson_first
    if first is None:
        first = torch.multinomial(valid[:, None].expand(lanes + (p,)).reshape(-1, p).to(dtype),
                                  1, generator=generator).reshape(lanes)
    sel_p = poisson_disk_sample(points[:, None].expand(lanes + (p, 3)), target_count,
                                torch.clamp(spacing[:, None] * poi_f, min=1e-6), max_iter,
                                valid=valid[:, None].expand(lanes + (p,)),
                                draws=(first.to(dev), draws.poisson_cands.to(dev)))
    poi = best(sel_p, _POISSON_FACTORS)
    return torch.stack([vox, fps, poi], -1)


def _cell_seed(seed: int, case: CloudCase, bucket: int) -> int:
    # a stable per-family fold: Python's str hash is randomized per process
    name_tag = zlib.crc32(case.family_name.encode()) % (2**31)
    return (seed * 1_000_003 + name_tag * 1009 + bucket) % (2**63)


def slot_scores_for_cell(case: CloudCase, bucket: int, n_slots: int,
                         max_iter: Optional[int] = None, draws: Optional[CellDraws] = None,
                         generator=None, dtype=torch.float32, device=None):
    """[n_slots, 3] (voxel, fps, poisson) score tensor for one (case,
    bucket) cell — computed once, shared by every variant. Without `draws`
    the cell draws from `generator` (a `torch.Generator` on `device`,
    default cuda)."""
    target = int(np.clip(bucket, 8, case.base_point_count))
    mi = max_iter if max_iter is not None else 8 * cloud_size(case)
    if draws is None:
        draws = draw_cell(generator, case, n_slots, mi, dtype, resolve_device(device))
    draws = draws._replace(**{f: getattr(draws, f).to(dtype) for f in (
        "structure", "jitter", "extra", "drop", "outliers", "dup_noise")
        if getattr(draws, f) is not None})
    pts, valid = _generate_cell_clouds(case, bucket, draws)
    return _score_clouds(pts, valid, target, mi, draws, generator)


# ---------------------------------------------------------------------------
# Observations + aggregation variants (mod.rs:89-:160, :488-:704)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PointSamplingObservation:
    """mod.rs:89 PointSamplingObservation analog."""

    family_name: str
    bucket: int
    total_scenarios: int
    initial_slots: Tuple[int, ...]
    selected_slots: Tuple[int, ...]
    escalated: bool
    median_scores: Tuple[float, float, float]  # voxel, fps, poisson
    min_scores: Tuple[float, float, float]
    max_scores: Tuple[float, float, float]
    wins: Tuple[int, int, int]

    def winner(self) -> str:
        return _METHODS[int(np.argmin(self.median_scores))]

    def runner_up_over_best(self) -> float:
        s = sorted(self.median_scores)
        return s[1] / max(s[0], 1e-9)

    def coverage_ratio(self) -> float:
        return len(self.selected_slots) / self.total_scenarios

    def comparison_key(self):
        return (self.family_name, self.bucket)


@dataclasses.dataclass(frozen=True)
class AggregationVariant:
    """One slot-selection policy (the 5 sibling files of mod.rs)."""

    descriptor: VariantDescriptor
    initial: str  # all|first|strided|percentile
    stride: int = 3
    percentiles: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0)
    escalate_on_vote_split: bool = False
    escalate_ratio_margin: Optional[float] = None

    def initial_slots(self, n: int) -> List[int]:
        if self.initial == "all":
            return list(range(n))
        if self.initial == "first":
            return [0]
        if self.initial == "strided":
            return sorted(set(range(0, n, self.stride)))
        if self.initial == "percentile":
            return sorted({int(round(p * (n - 1))) for p in self.percentiles})
        raise ValueError(self.initial)


AGGREGATION_VARIANTS = (
    AggregationVariant(VariantDescriptor("full-bucket", "every slot"),
                       "all"),
    AggregationVariant(VariantDescriptor("first-scenario", "slot 0 only"),
                       "first"),
    AggregationVariant(VariantDescriptor("sampled-bucket", "strided slots"),
                       "strided", stride=3),
    AggregationVariant(
        VariantDescriptor("percentile-bucket", "percentile spread"),
        "percentile"),
    AggregationVariant(
        VariantDescriptor("variance-triggered",
                          "adaptive two-stage escalation"),
        "percentile", percentiles=(0.0, 0.5),
        escalate_on_vote_split=True, escalate_ratio_margin=0.06),
)


def _observe(scores: np.ndarray, variant: AggregationVariant,
             family: str, bucket: int) -> PointSamplingObservation:
    """measure_bucket_observation (mod.rs:550) over the precomputed
    [S, 3] score tensor."""
    n = scores.shape[0]
    init = variant.initial_slots(n)
    selected = list(init)
    escalated = False
    sub = scores[np.asarray(init)]
    winners = np.argmin(sub, axis=1)
    vote_split = len(np.unique(winners)) > 1
    srt = np.sort(sub, axis=1)
    ratios = srt[:, 1] / np.maximum(srt[:, 0], 1e-9)
    ratio_close = (variant.escalate_ratio_margin is not None
                   and abs(float(np.median(ratios)) - 1.0)
                   < variant.escalate_ratio_margin)
    if ((variant.escalate_on_vote_split and vote_split) or ratio_close) \
            and len(selected) < n:
        selected = list(range(n))
        escalated = True
    sub = scores[np.asarray(selected)]
    med = tuple(float(x) for x in np.median(sub, axis=0))
    wins = np.bincount(np.argmin(sub, axis=1), minlength=3)
    return PointSamplingObservation(
        family_name=family, bucket=bucket, total_scenarios=n,
        initial_slots=tuple(init), selected_slots=tuple(selected),
        escalated=escalated, median_scores=med,
        min_scores=tuple(float(x) for x in np.min(sub, axis=0)),
        max_scores=tuple(float(x) for x in np.max(sub, axis=0)),
        wins=tuple(int(w) for w in wins))


def run_point_cloud_sampling_quality(
        seed: int = 0,
        problems: Optional[Dict[str, List[CloudCase]]] = None,
        scenarios_per_bucket: int = 10,
        variants: Sequence[AggregationVariant] = AGGREGATION_VARIANTS,
        max_iter: Optional[int] = None,
        draws: Optional[Dict[Tuple[str, int], CellDraws]] = None,
        dtype=torch.float32, device=None):
    """run_variant_suite (mod.rs:503): per-variant observation lists over
    every (case, bucket) cell + agreement stats vs the full-bucket
    reference variant. `draws`: {(family name, bucket): CellDraws}; else
    each cell draws from a `torch.Generator` on `device` (default cuda)
    seeded by `seed`, the family's CRC32 and the bucket. Returns
    {variant_name: {"observations": [...], "agreement_vs_reference":
    float, "mean_ratio_error_vs_reference": float,
    "average_coverage_ratio": float}}."""
    problems = problems if problems is not None else PROCESS_PROBLEMS
    device = resolve_device(device)
    cells = []  # (case, bucket, scores [S,3])
    for cases in problems.values():
        for case in cases:
            for bucket in case.buckets:
                gen = None
                if draws is None:
                    gen = torch.Generator(device=device).manual_seed(
                        _cell_seed(seed, case, bucket))
                scores = slot_scores_for_cell(
                    case, bucket, scenarios_per_bucket, max_iter=max_iter,
                    draws=None if draws is None else draws[case.family_name, bucket],
                    generator=gen, dtype=dtype, device=device)
                cells.append((case, bucket, scores.cpu().numpy()))

    reports = {}
    for variant in variants:
        obs = [_observe(s, variant, c.family_name, b) for c, b, s in cells]
        reports[variant.descriptor.name] = {
            "observations": obs,
            "average_coverage_ratio": float(np.mean(
                [o.coverage_ratio() for o in obs])),
        }
    ref = reports["full-bucket"]["observations"]
    for name, rep in reports.items():
        agree = np.mean([o.winner() == r.winner()
                         for o, r in zip(rep["observations"], ref)])
        ratio_err = np.mean(
            [abs(o.runner_up_over_best() - r.runner_up_over_best())
             for o, r in zip(rep["observations"], ref)])
        rep["agreement_vs_reference"] = float(agree)
        rep["mean_ratio_error_vs_reference"] = float(ratio_err)
    return reports
