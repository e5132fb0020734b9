"""Factor-graph problem structure: typed variable groups + factor blocks.

The port of rust_robotics_tpu/nlls/problem.py (reference:
rust_robotics_optimization/src/graph.rs — variables with an optional
manifold retraction and a fixed flag (:34, :60-64), factors (:108), the
problem (:119)). Factors of one type form one block: index tensors
[F, arity] and a measurement with leading F (a tensor, or a tuple or dict of
tensors, which `torch.func.vmap` maps leaf by leaf — the IMU factor's is a
dict), evaluated by one residual function under `torch.func.vmap`.
Jacobians are taken with respect to the tangent increment through the
group's retraction at δ=0, in reverse mode (`torch.func.jacrev`; see
nlls/solver.py on forward mode). Variables of one type live in one
[N, dim] tensor; fixed variables are masked, not removed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from rust_robotics_tpu_torch.nlls.kernels import RobustKernel


def additive_retract(values, delta):
    return values + delta


@dataclasses.dataclass(frozen=True)
class VariableGroup:
    """A typed block of variables: values [N, dim].

    retract(values [dim], delta [tangent_dim]) -> values [dim]; defaults to
    additive (tangent_dim == dim). `fixed_mask` [N] marks gauge-fixed
    entries (graph.rs:60-64): their increments are zeroed.
    """

    name: str
    values: Any
    retract: Callable[[Any, Any], Any] = additive_retract
    tangent_dim: int | None = None
    fixed_mask: Any | None = None

    @property
    def num(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[-1]

    @property
    def tdim(self) -> int:
        return self.tangent_dim if self.tangent_dim is not None else self.dim

    def fixed(self):
        """The fixed mask [N] as a bool tensor on the values' device."""
        if self.fixed_mask is None:
            return torch.zeros((self.num,), dtype=torch.bool, device=self.values.device)
        return torch.as_tensor(self.fixed_mask, dtype=torch.bool, device=self.values.device)

    def with_values(self, values) -> "VariableGroup":
        return dataclasses.replace(self, values=values)


@dataclasses.dataclass(frozen=True)
class FactorBlock:
    """F homogeneous factors.

    residual(*var_values, measurement) -> residual [rdim]; evaluated per
    factor under vmap. `groups` names the variable group each argument slot
    draws from; `indices` [F, arity] indexes into those groups.
    `information` is optional [F, rdim, rdim] (Λ; defaults to identity),
    `robust` the IRLS kernel (applied to rᵀΛr, solver.rs:228-257).
    """

    name: str
    residual: Callable[..., Any]
    groups: Sequence[str]
    indices: Any
    measurement: Any = None
    information: Any = None
    robust: RobustKernel = RobustKernel("l2")

    @property
    def num(self) -> int:
        return self.indices.shape[0]

    @property
    def arity(self) -> int:
        return self.indices.shape[1]


@dataclasses.dataclass(frozen=True)
class Problem:
    """groups: ordered variable groups; factors: homogeneous blocks."""

    groups: Sequence[VariableGroup]
    factors: Sequence[FactorBlock]

    def group(self, name: str) -> VariableGroup:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def group_index(self, name: str) -> int:
        for i, g in enumerate(self.groups):
            if g.name == name:
                return i
        raise KeyError(name)

    def values(self):
        return tuple(g.values for g in self.groups)

    def with_values(self, values) -> "Problem":
        groups = tuple(g.with_values(v) for g, v in zip(self.groups, values))
        return dataclasses.replace(self, groups=groups)

    def layout(self):
        """Global tangent offsets per group (fixed variables are masked
        later, not removed). Returns (offsets dict, total_dim)."""
        offsets = {}
        total = 0
        for g in self.groups:
            offsets[g.name] = total
            total += g.num * g.tdim
        return offsets, total
