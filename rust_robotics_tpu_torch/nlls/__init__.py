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
    solve_device,
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
from rust_robotics_tpu_torch.nlls.implicit import (  # noqa: F401
    implicit_vjp,
    solve_implicit,
)

__all__ = [
    "RobustKernel", "FactorBlock", "Problem", "VariableGroup",
    "SolverConfig", "solve", "solve_device", "solve_chain_lm", "block_tridiag_solve",
    "classify_chain_edges", "chain_nested_solve", "plan_banded",
    "solve_banded_lm", "solve_general_graph", "implicit_vjp", "solve_implicit",
]
