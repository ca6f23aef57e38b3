"""aligator_tpu — a batched trajectory-optimization framework in JAX.

A from-scratch JAX/XLA/Pallas re-imagination of the capabilities of the
reference `aligator` library (constrained trajectory optimization with
ProxDDP/FDDP solvers over a generalized Riccati linear-algebra core):
problems are pytrees of stacked per-stage arrays, models are pure functions,
solvers are `lax.scan`/`while_loop` programs that batch over thousands of
scenarios with `vmap` and shard over device meshes with `jax.sharding`.

Layers (bottom-up), mirroring the reference's architecture
(see SURVEY.md §1):

* :mod:`aligator_tpu.gar` — proximal LQ problems + Riccati solvers.
* :mod:`aligator_tpu.core` — manifolds, costs, dynamics, constraints, stage
  models, trajectory problems.
* :mod:`aligator_tpu.modelling` — concrete spaces, integrators, costs,
  residuals, rigid-body dynamics.
* :mod:`aligator_tpu.solvers` — ProxDDP and FDDP.
* :mod:`aligator_tpu.parallel` — mesh/sharding helpers for multi-device scaling.
* :mod:`aligator_tpu.utils` — rollout, logging, plotting.
"""

__version__ = "0.1.0"

import jax as _jax

# Matmul-precision policy (see _precision.py): global default 'high' for
# problem evaluation and rollouts; the gar numeric core pins 'highest'
# where μ-scaled KKT blocks demand full fp32
# (riccati/parallel/block_tridiag/fddp/contact). Respect an explicit user
# setting.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "high")

from . import gar

__all__ = ["gar", "__version__"]
