"""Acrobot swing-up (counterpart of reference ``examples/acrobot.py``; a
BASELINE.md parity config): double pendulum actuated ONLY at the elbow,
swing to the upright position, with control bounds."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody.robots import make_double_pendulum


def create_acrobot_problem(nsteps=120, timestep=0.025, u_bound=12.0, dtype=jnp.float64):
    model = make_double_pendulum(l1=0.5, l2=0.5, m1=1.0, m2=1.0)
    space = model.phase_space()
    nu = 1
    # underactuated: torque only on the second (elbow) joint
    B = jnp.array([[0.0], [1.0]], dtype)

    ode = MultibodyFreeFwdDynamics(model=model, actuation=B)
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x_up = jnp.array([jnp.pi, 0.0, 0.0, 0.0], dtype)  # upright
    w_x = jnp.diag(jnp.array([0.1, 0.1, 0.01, 0.01], dtype)) * timestep
    w_u = 1e-3 * jnp.eye(nu, dtype=dtype) * timestep
    w_term = jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0], dtype))

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_up, w_x),
        core.QuadraticControlCost(w_u),
    )
    term_cost = core.QuadraticStateCost(x_up, w_term)

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
    x0 = jnp.zeros((4,), dtype)  # hanging down
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem = create_acrobot_problem()
    cfg = solvers.ProxDDPConfig(
        tol=2e-3, mu_init=1e-2, max_iters=250, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[-1], "(target: [pi, 0, 0, 0])")
    print("max |u|:", float(jnp.max(jnp.abs(res.us))))
