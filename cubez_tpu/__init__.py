"""cubez_tpu — a structured-grid iterative-solver platform in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
kenoogl/CubeZ: Jacobi, point-SOR, 2-color red-black SOR, line-SOR via
parallel cyclic reduction, and preconditioned BiCGSTAB on a 3D cube grid,
each in constant-coefficient and variable-coefficient (MAF) form, with
multi-chip block decomposition over a 3D device mesh.
"""

from .core.grid import Grid, max_error
from .core.problem import Problem
from .solvers.api import SOLVERS, solve
from .solvers.driver import EPS_DEFAULT, SolveResult

__version__ = "0.3.0"

__all__ = [
    "Grid",
    "Problem",
    "SolveResult",
    "solve",
    "max_error",
    "SOLVERS",
    "EPS_DEFAULT",
    "__version__",
]
