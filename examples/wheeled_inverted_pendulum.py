"""Wheeled inverted pendulum (segway) point-to-point transfer.

Exercises ``WheeledInvertedPendulumDynamics`` — the counterpart of the
reference's ``modelling/dynamics/wheeled-inverted-pendulum.hpp:8`` (a recent
CHANGELOG addition there, with no in-repo example): drive the base 1 m
forward while keeping the pendulum upright (θ = 0 is the unstable
equilibrium), under a wheel-torque box bound.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorRK2
from aligator_tpu.modelling.dynamics.centroidal import (
    WheeledInvertedPendulumDynamics,
)


def create_wip_problem(
    nsteps=100, timestep=0.02, u_bound=3.0, x_goal=1.0, dtype=jnp.float64
):
    space = core.VectorSpace(4)
    nu = 1
    ode = WheeledInvertedPendulumDynamics(
        mass_cart=jnp.asarray(2.0, dtype),
        mass_pole=jnp.asarray(1.0, dtype),
        length=jnp.asarray(0.6, dtype),
        wheel_radius=jnp.asarray(0.15, dtype),
        gravity=jnp.asarray(9.81, dtype),
    )
    dyn = IntegratorRK2(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x_target = jnp.array([x_goal, 0.0, 0.0, 0.0], dtype)
    w_x = jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1], dtype)) * timestep
    w_u = 1e-2 * jnp.eye(nu, dtype=dtype) * timestep
    w_term = jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0], dtype))

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_target, w_x),
        core.QuadraticControlCost(w_u),
    )
    term_cost = core.QuadraticStateCost(x_target, w_term)

    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=-u_bound * jnp.ones((nu,), dtype),
                upper=u_bound * jnp.ones((nu,), dtype),
            ),
        ),
    )

    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    x0 = jnp.zeros((4,), dtype)  # upright at the origin
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem = create_wip_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-5, mu_init=1e-2, max_iters=60, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    xN = res.xs[-1]
    print("final state:", xN)
    print("max |tau|:", float(jnp.max(jnp.abs(res.us))))
    print("max |theta| along traj:", float(jnp.max(jnp.abs(res.xs[:, 1]))))
