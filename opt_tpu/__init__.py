"""opt_tpu: a JAX nonlinear least-squares framework.

A from-scratch JAX/XLA re-design of the capabilities of Opt (optlang.org;
reference fork multigrid101/Opt): users declare energy functions over
image-grid or graph-structured unknowns in a small embedded DSL, and the
framework produces a shape-specialized Gauss-Newton or Levenberg-Marquardt
solver with a matrix-free preconditioned-conjugate-gradient inner loop,
compiled by XLA for the GPU (and identically runnable on CPU).

See SURVEY.md at the repo root for the structural map of the reference this
rebuild tracks.
"""

from .dsl import expr
from .dsl.env import EnergyEnv
from .dsl.spec import ProblemSpec
from .runtime.api import NewState, OptState, Plan, Problem
from .solver.core import SOLVER_PARAMETER_DEFAULTS, SolverConfig

__version__ = "0.1.0"

__all__ = [
    "NewState",
    "OptState",
    "Plan",
    "Problem",
    "EnergyEnv",
    "ProblemSpec",
    "SolverConfig",
    "SOLVER_PARAMETER_DEFAULTS",
    "expr",
]
