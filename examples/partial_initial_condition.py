"""Partial initial condition (counterpart of reference
``examples/partial_initial_condition.py``).

Only one component of the initial state is pinned — the initial condition is
a ``FunctionSlice`` of a ``StateErrorResidual`` instead of the full-state
default — and the solver is run with ``force_initial_condition=False`` so the
free component is optimized like any other decision variable.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core, solvers


def make_problem(nsteps=100, dtype=jnp.float64):
    space = core.VectorSpace(2)
    nu = 2
    A = jnp.eye(2, dtype=dtype).at[0, 1].set(0.1)
    B = jnp.eye(2, dtype=dtype)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=jnp.zeros((2,), dtype))

    cost = core.QuadraticCost.create(
        jnp.zeros((2, 2), dtype), 1e-3 * jnp.eye(nu, dtype=dtype)
    )
    term_cost = core.QuadraticCost.create(
        jnp.eye(2, dtype=dtype), jnp.zeros((nu, nu), dtype)
    )
    stage = core.make_stage(cost, dyn, space, nu)

    # pin x0[1] = 0.1 only; x0[0] is free
    x0_desired = jnp.array([0.0, 0.1], dtype)
    init_cond = core.FunctionSlice(
        func=core.StateErrorResidual(target=x0_desired), indices=(1,)
    )
    return core.make_problem(
        x0_desired, stage, nsteps, term_cost, init_constraint=init_cond
    )


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem = make_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-6,
        mu_init=1e-2,
        max_iters=40,
        max_al_iters=10,
        force_initial_condition=False,
    )
    res = solvers.solve(problem, cfg)
    print("converged:", bool(res.conv))
    print("x0 =", res.xs[0], "(component 1 pinned to 0.1, component 0 free)")
    print("terminal state:", res.xs[-1])
