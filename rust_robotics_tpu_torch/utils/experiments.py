"""Research experiments harness.

Reference: crates/rust_robotics_core/src/experiments.rs (297 LoC, std-only):
`VariantDescriptor` (:16), `ExperimentSamplingPlan` (:25), SourceMetrics /
ExtensibilityMetrics (:44-51), `ExperimentVariantReport<T>` (:58),
`ExperimentObservation` trait (:68), `annotate_against_reference` (:89).

Host-side Python (this is research scaffolding, not compute); the port's
copy of rust_robotics_tpu/utils/experiments.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class VariantDescriptor:
    """experiments.rs:16 — a named algorithm variant under study."""

    name: str
    description: str = ""
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ExperimentSamplingPlan:
    """experiments.rs:25 — deterministic seeded replication plan."""

    seeds: Sequence[int]
    scenarios: Sequence[str] = ()

    @property
    def total_runs(self) -> int:
        return len(self.seeds) * max(1, len(self.scenarios))


@dataclasses.dataclass
class ExperimentVariantReport:
    """experiments.rs:58 — aggregated observations for one variant."""

    variant: VariantDescriptor
    observations: List[Any] = dataclasses.field(default_factory=list)
    summary: Dict[str, float] = dataclasses.field(default_factory=dict)
    reference_deltas: Dict[str, float] = dataclasses.field(default_factory=dict)

    def record(self, obs: Any):
        self.observations.append(obs)

    def summarize(self, reducers: Dict[str, Callable[[List[Any]], float]]):
        self.summary = {k: fn(self.observations) for k, fn in reducers.items()}
        return self.summary


def run_experiment(variants: Sequence[VariantDescriptor],
                   plan: ExperimentSamplingPlan,
                   run_fn: Callable[[VariantDescriptor, int, Optional[str]], Any],
                   reducers: Dict[str, Callable[[List[Any]], float]]):
    """Execute every (variant × seed × scenario) cell, deterministic order."""
    reports = []
    for v in variants:
        rep = ExperimentVariantReport(v)
        for scenario in plan.scenarios or (None,):
            for seed in plan.seeds:
                rep.record(run_fn(v, seed, scenario))
        rep.summarize(reducers)
        reports.append(rep)
    return reports


def annotate_against_reference(reports: List[ExperimentVariantReport],
                               reference_name: str):
    """experiments.rs:89 — per-metric deltas vs a designated reference
    variant."""
    ref = next(r for r in reports if r.variant.name == reference_name)
    for rep in reports:
        rep.reference_deltas = {
            k: rep.summary[k] - ref.summary[k] for k in rep.summary
        }
    return reports


def sign_test_p_value(wins: int, losses: int) -> float:
    """One-sided exact binomial sign test (ties excluded): probability of
    >= `wins` successes in `wins + losses` fair coin flips. The paired
    significance machinery behind the reference's planner comparisons
    (crates/rust_robotics_planning/tests/any_angle_statistical_test.rs —
    the README.md:407 "p = 0.025" claim)."""
    import math

    n = wins + losses
    if n == 0:
        return 1.0
    return sum(math.comb(n, k) for k in range(wins, n + 1)) / 2.0 ** n
