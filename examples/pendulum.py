"""Pendulum and double-pendulum swing-up (counterparts of reference
``examples/pendulum.py`` / double-pendulum examples), using the rigid-body
layer."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody.robots import make_double_pendulum, make_pendulum


def create_pendulum_problem(nsteps=80, timestep=0.025, u_bound=2.5, dtype=jnp.float64):
    model = make_pendulum(l=0.5, m=1.0)
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=jnp.eye(1, dtype=dtype))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))
    x_up = jnp.array([jnp.pi, 0.0], dtype)
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_up, jnp.diag(jnp.array([0.1, 0.01], dtype)) * timestep),
        core.QuadraticControlCost(1e-3 * jnp.eye(1, dtype=dtype) * timestep),
    )
    term_cost = core.QuadraticStateCost(x_up, jnp.diag(jnp.array([100.0, 10.0], dtype)))
    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros(1, dtype)),
            core.BoxConstraint(lower=-u_bound * jnp.ones(1, dtype), upper=u_bound * jnp.ones(1, dtype)),
        ),
    )
    stage = core.make_stage(rcost, dyn, space, 1, constraints)
    return core.make_problem(jnp.zeros(2, dtype), stage, nsteps, term_cost)


def create_double_pendulum_problem(nsteps=100, timestep=0.02, dtype=jnp.float64):
    model = make_double_pendulum(l1=0.5, l2=0.5)
    space = model.phase_space()
    ode = MultibodyFreeFwdDynamics(model=model, actuation=jnp.eye(2, dtype=dtype))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))
    x_up = jnp.array([jnp.pi, 0.0, 0.0, 0.0], dtype)
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_up, 0.01 * jnp.eye(4, dtype=dtype) * timestep),
        core.QuadraticControlCost(1e-3 * jnp.eye(2, dtype=dtype) * timestep),
    )
    term_cost = core.QuadraticStateCost(x_up, jnp.diag(jnp.array([100.0, 100.0, 10.0, 10.0], dtype)))
    stage = core.make_stage(rcost, dyn, space, 2)
    return core.make_problem(jnp.zeros(4, dtype), stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    for name, prob in (
        ("pendulum", create_pendulum_problem()),
        ("double_pendulum", create_double_pendulum_problem()),
    ):
        cfg = solvers.ProxDDPConfig(tol=1e-3, max_iters=250, rollout="nonlinear")
        res = solvers.solve(prob, cfg)
        print(f"{name}: conv={bool(res.conv)} iters={int(res.num_iters)} "
              f"xN={res.xs[-1][:2]}")
