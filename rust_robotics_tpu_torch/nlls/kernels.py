"""Robust loss kernels ρ(s) over squared Mahalanobis errors.

The port of rust_robotics_tpu/nlls/kernels.py (reference:
rust_robotics_optimization/src/loss.rs:11-75): L2, Huber, PseudoHuber and
Cauchy, each returning (value, ρ'(s)), where ρ'(s) is the IRLS weight applied
to JᵀΛr and JᵀΛJ (solver.rs:228-257). Branchless, batched over a factor axis.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 2.220446049250313e-16  # f64::EPSILON, matching loss.rs's delta guard


@dataclasses.dataclass(frozen=True)
class RobustKernel:
    """kind in {'l2', 'huber', 'pseudo_huber', 'cauchy'}; delta as in the
    reference (ignored for l2)."""

    kind: str = "l2"
    delta: float = 1.0

    def evaluate(self, squared_error):
        """(value, weight) with weight = ρ'(s). loss.rs:26-75 semantics."""
        s = torch.clamp(squared_error, min=0.0)
        d = max(abs(self.delta), _EPS)
        d2 = d * d
        if self.kind == "l2":
            return s, torch.ones_like(s)
        if self.kind == "huber":
            root = torch.sqrt(torch.clamp(s, min=_EPS))
            out_value = 2.0 * d * root - d2
            out_w = d / root
            inl = s <= d2
            return torch.where(inl, s, out_value), torch.where(inl, torch.ones_like(s), out_w)
        if self.kind == "pseudo_huber":
            aux = 1.0 + s / d2
            root = torch.sqrt(aux)
            return 2.0 * d2 * (root - 1.0), 1.0 / root
        if self.kind == "cauchy":
            aux = 1.0 + s / d2
            return d2 * torch.log(aux), 1.0 / aux
        raise ValueError(f"unknown robust kernel {self.kind!r}")
