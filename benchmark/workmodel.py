"""The least work of one chain-LM iteration, and the card peaks it is held to.

One iteration of the LM on an SE(2) chain of n poses with L loop closures,
for G graphs in lock-step, as the algorithm needs it whatever implements
it: linearise every edge, damp the diagonal, factor the block-tridiagonal
chain by cyclic reduction, apply the factor to the gradient, to the 3L
columns of the loop-closure factor U and to the Woodbury correction, form
and factor the capacitance matrix W⁻¹ + Uᵀ T⁻¹ U, retract and cost the
trial. The ladder's counts are the port's own model (its
`parallel/accounting.py`: 14·b³ a block to factor, 8·m·b²·r an apply),
held equal to it by `tests/test_harness_workmodel.py`. Bytes count each
input read once and each output written once: the poses in and out, the
measurements, information and closure endpoints, the LM's scalars.

The peaks are the data-sheet table of the port's `utils/roofline.py::CARDS`
(dense rates, float32 outside the tensor cores), copied so that the
yardstick stays fixed.
"""

from __future__ import annotations

TANGENT = 3   # SE(2) tangent and residual width
F32 = 4       # bytes
I64 = 8

# Per edge: the residual (sin/cos of a yaw, t_j − t_i, two 2×2 rotations
# applied, the yaw difference wrapped), 22 operations; the Jacobians' 2×2
# product and rotated derivative, 24.
LINEARIZE_OPS_PER_EDGE = 46
# Per edge: ΛA, ΛB, AᵀΛA, BᵀΛB, AᵀΛB (five 3×3×3 products of 27
# multiplies and 18 adds), Λr, Aᵀ(Λr), Bᵀ(Λr) (three of 9 and 6), and the
# 3·9 + 2·3 adds into the blocks and the gradient.
NORMAL_OPS_PER_EDGE = 5 * 45 + 3 * 15 + 33
# Per edge of the trial: its residual (22), Λr (15) and rᵀΛr (5).
COST_OPS_PER_EDGE = 42
# Per pose: the damping (2 a diagonal entry), the retraction with its yaw
# wrap (7), the gradient's max and the step's squared norm (6).
POSE_OPS = 3 * 2 + 7 + 6

# (fragment of torch.cuda.get_device_name(), bytes/s, float32 operations/s),
# the first match wins
CARDS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)


def card_peaks(name: str):
    """(bytes/s, float32 operations/s) of the card, or None for a card the
    table does not know."""
    for fragment, bytes_per_s, flops in CARDS:
        if fragment in name:
            return bytes_per_s, flops
    return None


def ladder_factor_ops(m: int, b: int) -> float:
    """Cyclic reduction of m blocks of size b (`accounting.py`)."""
    return 14.0 * m * b**3


def ladder_apply_ops(m: int, b: int, r: int) -> float:
    """A ladder apply with r right-hand columns (`accounting.py`)."""
    return 8.0 * m * b**2 * r


def ladder_ops(n: int, closures: int) -> float:
    """One iteration's ladder: a factor and an apply to 3L + 2 columns (the
    gradient, U's columns, the correction)."""
    return ladder_factor_ops(n, TANGENT) + ladder_apply_ops(n, TANGENT,
                                                            TANGENT * closures + 2)


def capacitance_ops(closures: int) -> float:
    """Uᵀ(T⁻¹U) with U's six non-zero rows a column, W⁻¹ added, its
    Cholesky factor and the two triangular solves, Uᵀ(T⁻¹g)."""
    k = TANGENT * closures
    return 12.0 * k * k + k * k + k**3 / 3.0 + 2.0 * k * k + 12.0 * k


def chain_lm_iteration(n: int, closures: int, lanes: int = 1) -> dict:
    """{"ops", "bytes"} of one LM iteration of `lanes` graphs of n poses and
    `closures` loop closures each, all graphs sharing the measurements."""
    edges = n - 1 + closures
    per_lane = (edges * (LINEARIZE_OPS_PER_EDGE + NORMAL_OPS_PER_EDGE + COST_OPS_PER_EDGE)
                + n * POSE_OPS + ladder_ops(n, closures) + capacitance_ops(closures))
    poses = lanes * n * TANGENT * F32 * 2                   # read and written
    problem = edges * (TANGENT + TANGENT * TANGENT) * F32 + closures * 2 * I64 + n
    scalars = lanes * 7 * F32 * 2                           # the LM's state a graph
    return {"ops": lanes * per_lane, "bytes": float(poses + problem + scalars)}


def least_time(work: dict, peaks) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of operations over the
    float32 peak and bytes over the memory bandwidth."""
    bytes_per_s, flops = peaks
    by_ops, by_bytes = work["ops"] / flops, work["bytes"] / bytes_per_s
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
