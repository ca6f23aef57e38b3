"""Dense-LQR solver benchmark (reference ``bench/lqr.cpp`` analog):
double-integrator-style dense LQR at dim=56, nu=22, horizon 100, solved by
ProxDDP and FDDP with the reference's budget (max_iters=2, tol=1e-7),
batched over randomized initial states. Prints one JSON line per solver.

Usage: python bench_lqr.py [batch]
"""

import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from aligator_tpu import core, solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402


def make_dense_lqr(nx=56, nu=22, nsteps=100, dtype=jnp.float32):
    """Random stable dense LQR (the reference uses a dense random problem,
    bench/lqr.cpp:23-40)."""
    key = jax.random.PRNGKey(42)
    kA, kB, kQ, kR = jax.random.split(key, 4)
    import numpy as np

    A = jax.random.normal(kA, (nx, nx), dtype) / jnp.sqrt(jnp.asarray(nx, dtype))
    # spectral normalization on the host
    rho = float(np.abs(np.linalg.eigvals(np.asarray(A, np.float64))).max())
    A = jnp.asarray(0.95 / rho, dtype) * A
    B = jax.random.normal(kB, (nx, nu), dtype) / jnp.sqrt(jnp.asarray(nu, dtype))
    Qh = jax.random.normal(kQ, (nx, nx), dtype)
    Q = (Qh @ Qh.T) / nx + 0.1 * jnp.eye(nx, dtype=dtype)
    Rh = jax.random.normal(kR, (nu, nu), dtype)
    R = (Rh @ Rh.T) / nu + 0.1 * jnp.eye(nu, dtype=dtype)

    space = core.VectorSpace(nx)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=jnp.zeros((nx,), dtype))
    cost = core.QuadraticCost.create(Q, R)
    term = core.QuadraticCost.create(10.0 * Q, jnp.zeros((nu, nu), dtype))
    stage = core.make_stage(cost, dyn, space, nu)
    x0 = jnp.ones((nx,), dtype)
    return core.make_problem(x0, stage, nsteps, term)


def initial_states(batch, nx=56, dtype=jnp.float32):
    return jnp.ones((nx,), dtype) + 0.1 * jax.random.normal(
        jax.random.PRNGKey(7), (batch, nx), dtype
    )


def solvers_one():
    """``{solver: (problem, x0) -> results}`` with the reference budget."""
    return {
        "proxddp": lambda problem, x0: solvers.solve(
            replace(problem, x0=x0),
            solvers.ProxDDPConfig(
                tol=1e-7, mu_init=1e-9, max_iters=2, rollout="linear"
            ),
        ),
        "fddp": lambda problem, x0: solvers.fddp.solve(
            replace(problem, x0=x0),
            solvers.FDDPConfig(tol=1e-7, max_iters=2),
        ),
    }


def run_both(batch=256):
    """ProxDDP-vs-FDDP solves/s at the reference lqr.cpp shape; returns a
    dict (also folded into ``bench.py``'s single JSON line — the reference
    compares both solvers in ``bench/lqr.cpp:23-57``)."""
    from bench import fleet_fn, timed

    problem = make_dense_lqr(dtype=jnp.float32)
    x0s = initial_states(batch, problem.x0.shape[0])
    return {
        name: batch / timed(fleet_fn(problem, one), x0s, n_rep=3)[0]
        for name, one in solvers_one().items()
    }


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    rates = run_both(batch)
    for name, rate in rates.items():
        print(
            json.dumps(
                {
                    "metric": f"lqr56_{name}_solves_per_sec",
                    "value": round(rate, 1),
                    "unit": "solves/s",
                    "nx": 56,
                    "nu": 22,
                    "nsteps": 100,
                    "batch": batch,
                }
            )
        )


if __name__ == "__main__":
    main()
