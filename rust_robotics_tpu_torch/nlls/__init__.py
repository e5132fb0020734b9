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
from rust_robotics_tpu_torch.nlls.banded import (  # noqa: F401
    plan_banded,
    solve_banded_lm,
    solve_general_graph,
)
from rust_robotics_tpu_torch.nlls.tridiag import (  # noqa: F401
    block_tridiag_solve,
    chain_nested_solve,
    classify_chain_edges,
    solve_chain_lm,
)

__all__ = [
    "RobustKernel", "FactorBlock", "Problem", "VariableGroup",
    "SolverConfig", "solve", "solve_chain_lm", "block_tridiag_solve",
    "classify_chain_edges", "chain_nested_solve", "plan_banded",
    "solve_banded_lm", "solve_general_graph",
]

# Names of the JAX package's nlls that the port does not have yet: the
# device-resident LM of the dense and matfree_pcg solvers (ROADMAP.md A9)
# and the implicit gradients (A13).
_NOT_PORTED = {
    "solve_device": "nlls/solver.py::solve_device",
    "implicit_vjp": "nlls/implicit.py",
    "solve_implicit": "nlls/implicit.py",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"{name} ({_NOT_PORTED[name]}) is not ported yet: it belongs to slice 4 "
            f"(the pose-graph solvers) of the port, ROADMAP.md A9 and A13")
    raise AttributeError(name)
