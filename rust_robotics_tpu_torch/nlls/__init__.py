"""The NLLS engine: factor blocks, robust kernels and the LM/GN solver (the
port of rust_robotics_tpu/nlls, re-exported as there)."""

from rust_robotics_tpu_torch.nlls.kernels import RobustKernel  # noqa: F401
from rust_robotics_tpu_torch.nlls.problem import (  # noqa: F401
    FactorBlock,
    Problem,
    VariableGroup,
)
from rust_robotics_tpu_torch.nlls.solver import (  # noqa: F401
    SolverConfig,
    solve,
)

__all__ = [
    "RobustKernel", "FactorBlock", "Problem", "VariableGroup",
    "SolverConfig", "solve",
]

# Names of the JAX package's nlls that the port does not have yet: the
# device-resident LM, the chain (block-tridiagonal) solver and the implicit
# gradients, all queued as slice 4 in ROADMAP.md (A9, A10, A13).
_NOT_PORTED = {
    "solve_device": "nlls/solver.py::solve_device",
    "solve_chain_lm": "nlls/tridiag.py",
    "block_tridiag_solve": "nlls/tridiag.py",
    "classify_chain_edges": "nlls/tridiag.py",
    "implicit_vjp": "nlls/implicit.py",
    "solve_implicit": "nlls/implicit.py",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"{name} ({_NOT_PORTED[name]}) is not ported yet: it belongs to slice 4 "
            f"(the SE(2) pose-graph solvers) of the port")
    raise AttributeError(name)
