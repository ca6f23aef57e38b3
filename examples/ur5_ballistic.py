"""UR5 ballistic throw: land a released projectile on a ground target.

Counterpart of the reference ``examples/ur10_ballistic.py`` (arm + ball
free-flyer, constrained dynamics while held, free flight after release,
terminal constraint = ball at target). Here the free-flight phase is
collapsed analytically: the ball is released from the end-effector at the
final knot, and :class:`BallisticLandingResidual` constrains the landing
point of the release-state projectile — a terminal *equality* constraint on
a nonlinear function of (q, v), which exercises the solver's terminal
constraint machinery far from the usual state-error form.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody.extra_residuals import (
    BallisticLandingResidual,
)
from aligator_tpu.modelling.multibody.robots import make_ur5


def create_ballistic_problem(
    nsteps=40,
    timestep=0.025,
    tau_bound=90.0,
    target_xy=(1.6, 0.8),
    dtype=jnp.float64,
):
    model = make_ur5()
    nv = model.nv
    space = model.phase_space()
    nu = nv

    dyn_ode = MultibodyFreeFwdDynamics(
        model=model, actuation=jnp.eye(nv, dtype=dtype)
    )
    dyn = IntegratorSemiImplEuler(
        ode=dyn_ode, timestep=jnp.asarray(timestep, dtype)
    )

    landing = BallisticLandingResidual(
        model=model,
        target_xy=jnp.asarray(target_xy, dtype),
        gravity=jnp.asarray(9.81, dtype),
        z_ground=jnp.asarray(0.0, dtype),
        frame_id=model.frame_id("ee"),
    )

    w_u = 1e-4 * jnp.eye(nu, dtype=dtype) * timestep
    w_x = jnp.zeros((2 * nv, 2 * nv), dtype)
    w_x = w_x.at[:nv, :nv].set(0.01 * jnp.eye(nv, dtype=dtype) * timestep)
    x_ref = jnp.zeros((2 * nv,), dtype)

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_ref, w_x),
        core.QuadraticControlCost(w_u),
    )
    # terminal: damp joint velocities a little (the throw itself is handled
    # by the hard landing constraint)
    w_xt = jnp.zeros((2 * nv, 2 * nv), dtype)
    w_xt = w_xt.at[nv:, nv:].set(1e-3 * jnp.eye(nv, dtype=dtype))
    term_cost = core.QuadraticStateCost(x_ref, w_xt)

    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=-tau_bound * jnp.ones((nu,), dtype),
                upper=tau_bound * jnp.ones((nu,), dtype),
            ),
        ),
    )
    term_constraints = ((landing, core.EqualityConstraint()),)

    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    q0 = jnp.asarray([0.0, -1.2, 1.8, -0.6, 0.0, 0.0], dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])
    problem = core.make_problem(
        x0, stage, nsteps, term_cost, term_constraints=term_constraints
    )
    return problem, model, landing


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from aligator_tpu import solvers

    problem, model, landing = create_ballistic_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=300, rollout="nonlinear",
        ls_strategy="armijo",
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    xN = res.xs[-1]
    miss = landing.value(problem.space, xN, jnp.zeros(6))
    print("landing miss (m):", np.asarray(miss))
    from aligator_tpu.modelling.multibody import model as rbd

    q, v = xN[: model.nq], xN[model.nq :]
    R, p = rbd.frame_placement(model, q, model.frame_id("ee"))
    V = rbd.frame_velocity(model, q, v, model.frame_id("ee"))
    print("release pos:", np.asarray(p), "world vel:", np.asarray(R @ V[:3]))
    print("max |tau|:", float(jnp.max(jnp.abs(res.us))))
