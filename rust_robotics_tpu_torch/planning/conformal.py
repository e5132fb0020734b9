"""Conformal-prediction SIPP (CP-SIPP): confidence-filtered time-expanded
planning around predicted obstacle trajectories.

The port of rust_robotics_tpu/planning/conformal.py. Reference:
crates/rust_robotics_planning/src/conformal_sipp.rs (Liang et al.,
"Time-aware Motion Planning in Dynamic Environments with Conformal
Prediction", L4DC 2026 reproduction slice) — calibration nonconformity
scores per horizon: ‖predicted − observed‖ over episodes (:66); cell
confidence at (x, y, t) = empirical coverage fraction of scores ≤
(distance to the nearest predicted obstacle − obstacle_radius), 0 inside
the footprint, 1 when no prediction covers t (:355-:384); conformal radius
= empirical quantile at rank ⌈confidence·n⌉ plus the footprint radius
(:386-:392); a cell is traversable at t when confidence ≥
required_confidence; plan reports min_confidence over waypoints and the
Boole-union violation bound Σ(1 − c_t) capped at 1 (:130-:140).

The confidence field is one [T+1, W, H] tensor (distances to all
predicted obstacles batch over the grid; coverage is a broadcast compare
and a count over scores) and the search is the time-expanded wavefront of
`planning/temporal.py` over the thresholded mask. The reference's jitted
field squares and adds the distance in one multiply-add; the port rounds
the same way (`_numeric.fma`), and counts coverage as a sum divided by the
episodes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import fma, norm2, sqrt_rn, true_div
from rust_robotics_tpu_torch.planning.grid import _bool_on, _float_on
from rust_robotics_tpu_torch.planning.temporal import (
    earliest_arrival,
    extract_time_path,
    time_expanded_costs,
)

__all__ = [
    "calibration_errors_from_trajectories",
    "empirical_quantile",
    "conformal_radius_at",
    "confidence_field",
    "conformal_sipp_plan",
]


def calibration_errors_from_trajectories(predictions, observations, device=None,
                                         dtype=torch.float32):
    """[E, T+1, 2] × [E, T+1, 2] → scores [T+1, E]: per-horizon Euclidean
    nonconformity (conformal_sipp.rs:66)."""
    predictions = _float_on(predictions, device, dtype)
    observations = _float_on(observations, predictions.device, dtype)
    return norm2(predictions - observations).T


def empirical_quantile(scores, confidence: float):
    """Rank-⌈confidence·n⌉ order statistic over the last axis
    (conformal_sipp.rs:386)."""
    scores = torch.sort(scores, dim=-1).values
    n = scores.shape[-1]
    idx = min(max(math.ceil(confidence * n) - 1, 0), n - 1)
    return scores[..., idx]


def conformal_radius_at(calibration_errors, t, required_confidence, obstacle_radius=0.0):
    """Quantile radius + footprint at horizon t (conformal_radius_at)."""
    return empirical_quantile(calibration_errors[t], required_confidence) + obstacle_radius


def confidence_field(predicted, predicted_mask, calibration_errors, obstacle_radius,
                     width: int, height: int, device=None, dtype=torch.float32):
    """Empirical confidence [T+1, W, H] (confidence_from_inputs):

    predicted [O, T+1, 2] obstacle centers (+ validity mask [O, T+1]);
    calibration_errors [T+1, E]. confidence = share of scores ≤
    min-distance − radius; 0 when inside the footprint; 1 when no obstacle
    covers t. On `device` (default cuda; predicted's own when a tensor)."""
    pred = _float_on(predicted, device, dtype)
    dev = pred.device
    mask = _bool_on(predicted_mask, dev)
    scores = _float_on(calibration_errors, dev, dtype)  # [T+1, E]
    gx = torch.arange(width, device=dev).to(dtype)[:, None]
    gy = torch.arange(height, device=dev).to(dtype)[None, :]
    dx = gx - pred[:, :, 0, None, None]
    dy = gy - pred[:, :, 1, None, None]
    d = sqrt_rn(fma(dx, dx, dy * dy))  # [O, T+1, W, H]
    d = torch.where(mask[:, :, None, None], d, torch.inf)
    min_d = torch.amin(d, dim=0)  # [T+1, W, H]
    margin = min_d - obstacle_radius
    covered = torch.zeros_like(margin)
    for e in range(scores.shape[1]):
        covered = covered + (scores[:, e, None, None] <= margin).to(dtype)
    covered = true_div(covered, scores.shape[1])
    conf = torch.where(margin < 0.0, 0.0, covered)
    return torch.where(torch.isinf(min_d), 1.0, conf)


def conformal_sipp_plan(static_blocked, predicted, calibration_errors, start, goal,
                        required_confidence: float = 0.9, obstacle_radius: float = 0.5,
                        predicted_mask=None, device=None, dtype=torch.float32):
    """CP-SIPP plan (ConformalSippPlanner::plan): threshold the confidence
    field at required_confidence, run the time-expanded wavefront, report
    (path [T+1, 2], arrival, min_confidence, trajectory_violation_bound).
    Returns None when no confident path exists within the horizon. On
    `device` (default cuda; static_blocked's own when a tensor); start and
    goal host integers."""
    static_blocked = _bool_on(static_blocked, device)
    dev = static_blocked.device
    w, h = static_blocked.shape
    pred = _float_on(predicted, dev, dtype)
    if predicted_mask is None:
        predicted_mask = torch.ones(pred.shape[:2], dtype=torch.bool, device=dev)
    conf = confidence_field(pred, predicted_mask, calibration_errors, obstacle_radius, w, h,
                            dtype=dtype)
    free_t = (~static_blocked)[None] & (conf >= required_confidence)
    costs = time_expanded_costs(free_t, start, dtype=dtype)
    t_arr, cost = earliest_arrival(costs, goal)
    t_arr = int(t_arr)
    if t_arr < 0:
        return None
    path = extract_time_path(costs, goal, t_arr)
    conf_np = conf.cpu().numpy()
    waypoint_conf = np.array([conf_np[t, path[t, 0], path[t, 1]] for t in range(len(path))])
    return {
        "path": path,
        "arrival": t_arr,
        "cost": float(cost),
        "min_confidence": float(waypoint_conf.min()),
        "trajectory_violation_bound": float(min(np.sum(1.0 - waypoint_conf), 1.0)),
        "confidence_field": conf,
    }
