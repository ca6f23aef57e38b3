"""gar — proximal LQ problems and Riccati solvers (the performance core).

Accelerator-native counterpart of the reference's ``aligator/gar`` subsystem
(``include/aligator/gar/``): stacked-array LQ problems, a serial proximal
Riccati solver expressed as `lax.scan`, a parallel-in-time solver via leg
condensation, an O(log N) associative-scan solver, a fused Triton kernel
(Pallas) with a custom_vmap dispatcher, and dense-KKT oracles for testing.
"""

from .lqr_problem import (
    initialize_solution,
    kkt_residual_vectors,
    LQRKnots,
    LQRProblem,
    add_parameterization,
    dense_kkt,
    dense_solve,
    kkt_error,
    random_convex_problem,
    random_problem,
    split_solution,
)
from . import associative
from .riccati import (
    RiccatiFactors,
    backward,
    forward,
    solve,
    solve_and_gains,
    solve_guarded,
    solve_refined,
)

__all__ = [
    "LQRKnots",
    "LQRProblem",
    "add_parameterization",
    "dense_kkt",
    "dense_solve",
    "kkt_error",
    "random_convex_problem",
    "random_problem",
    "initialize_solution",
    "split_solution",
    "RiccatiFactors",
    "backward",
    "forward",
    "solve",
    "solve_guarded",
    "solve_and_gains",
    "associative",
    "solve_refined",
    "kkt_residual_vectors",
]
