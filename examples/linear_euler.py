"""Continuous linear ODE + explicit Euler (reference
``examples/linear_euler.py``): an unstable 2-state linear system driven to
the origin through the `LinearODE` → `IntegratorEuler` pipeline — the
minimal continuous-dynamics example."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorEuler, LinearODE


def create_linear_euler_problem(nsteps=20, timestep=0.001, dtype=jnp.float64):
    nx = 2
    nu = 2
    space = core.VectorSpace(nx)
    ode = LinearODE(
        A=jnp.array([[1.0, -0.2], [10.0, 1.0]], dtype),
        B=jnp.eye(nx, dtype=dtype),
        c=jnp.zeros(nx, dtype),
    )
    dyn = IntegratorEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))
    w_x = 0.1 * jnp.eye(nx, dtype=dtype)
    w_u = 1e-3 * jnp.eye(nu, dtype=dtype)
    rcost = core.QuadraticCost.create(w_x * timestep, w_u * timestep)
    term_cost = core.QuadraticCost.create(w_x, jnp.zeros((nu, nu), dtype))
    stage = core.make_stage(rcost, dyn, space, nu, ())
    x0 = jnp.array([1.0, -0.5], dtype)
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem = create_linear_euler_problem()
    res = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-8))
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[-1])
