"""Double-pendulum swing-up (reference ``examples/double_pendulum.py``,
which builds the acrobot-style double pendulum without Pinocchio): both
joints actuated, swing to upright under torque bounds, on the analytic
rigid-body model (`make_double_pendulum` — the same model the multibody
test battery cross-checks against the closed-form Lagrangian dynamics and
MuJoCo)."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import (
    MultibodyFreeFwdDynamics,
)
from aligator_tpu.modelling.multibody.robots import make_double_pendulum


def create_double_pendulum_problem(
    nsteps=120, timestep=0.025, u_bound=25.0, dtype=jnp.float64
):
    model = make_double_pendulum()
    space = model.phase_space()
    nu = 2
    ode = MultibodyFreeFwdDynamics(
        model=model, actuation=jnp.eye(2, dtype=dtype)
    )
    dyn = IntegratorSemiImplEuler(
        ode=ode, timestep=jnp.asarray(timestep, dtype)
    )
    # upright: both angles at pi (hanging-down zero convention)
    x_tgt = jnp.array([jnp.pi, 0.0, 0.0, 0.0], dtype)
    w_x = jnp.diag(jnp.array([1.0, 1.0, 0.1, 0.1], dtype)) * timestep
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_tgt, w_x),
        core.QuadraticControlCost(1e-3 * jnp.eye(nu, dtype=dtype) * timestep),
    )
    term_cost = core.QuadraticStateCost(
        x_tgt, 100.0 * jnp.eye(space.ndx, dtype=dtype)
    )
    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=jnp.full((nu,), -u_bound, dtype),
                upper=jnp.full((nu,), u_bound, dtype),
            ),
        ),
    )
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    x0 = jnp.zeros((4,), dtype)
    return core.make_problem(x0, stage, nsteps, term_cost), model


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model = create_double_pendulum_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-5, mu_init=1e-2, max_iters=300, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    # like the cartpole swing-up, the conv flag lags the physical outcome
    # at these budgets — assert the swing-up itself
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("xN:", res.xs[-1], "(target: [pi, 0, 0, 0])")
    print("max |u|:", float(jnp.max(jnp.abs(res.us))))
    assert float(jnp.abs(res.xs[-1][0] - jnp.pi)) < 0.02
