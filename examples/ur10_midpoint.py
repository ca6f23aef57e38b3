"""UR10 reach integrated with the implicit midpoint rule (counterpart of
reference ``examples/ur10_midpoint.py``): the symplectic implicit integrator
exercised end-to-end through the nonlinear rollout (Newton-in-the-loop,
reference ``utils/forward-dyn.hpp:29-57``), warm-started from a quasi-static
torque rollout."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorMidpoint
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual
from aligator_tpu.modelling.multibody.robots import make_ur10, ur10_effort_limits


def create_ur10_midpoint_problem(nsteps=50, timestep=0.02, dtype=jnp.float64):
    model = make_ur10()
    nv = model.nv
    space = model.phase_space()
    nu = nv

    ode = MultibodyFreeFwdDynamics(model=model, actuation=jnp.eye(nv, dtype=dtype))
    dyn = IntegratorMidpoint(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x0 = space.neutral().astype(dtype)
    q0, v0 = x0[: model.nq], x0[model.nq :]
    # quasi-static torque (reference ur10_midpoint.py:37 pin.rnea)
    u0 = rbd.rnea(model, q0, v0, jnp.zeros((nv,), dtype))

    # reference target (ur10_midpoint.py:40): [0.5, 0.7, 1.2] * 0.707
    p_target = jnp.array([0.5, 0.7, 1.2], dtype) * 0.707
    ee = model.frame_id("ee")
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target, frame_id=ee)

    w_x = jnp.concatenate([jnp.full(nv, 1e-6), jnp.full(nv, 5e-2)])
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, jnp.diag(w_x).astype(dtype) * timestep),
        core.QuadraticControlCost(
            1e-3 * jnp.eye(nu, dtype=dtype) * timestep, target=u0
        ),
    )
    term_cost = core.QuadraticResidualCost(
        residual=frame_res, weights=6.0 * jnp.eye(3, dtype=dtype)
    )

    lim = ur10_effort_limits().astype(dtype)
    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(lower=-lim, upper=lim),
        ),
    )
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    problem = core.make_problem(x0, stage, nsteps, term_cost)
    return problem, model, (u0, p_target)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers
    from aligator_tpu.utils.rollout import rollout

    problem, model, (u0, p_target) = create_ur10_midpoint_problem()
    us_init = jnp.tile(u0[None], (problem.nsteps, 1))
    xs_init = rollout(
        problem.stages.dynamics, model.phase_space(), problem.x0, us_init
    )
    # monotone Armijo: the nonmonotone default admits a diverging
    # Gauss-Newton cycle on this stiff implicit-integrator problem
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=80, rollout="nonlinear",
        rollout_max_iters=5, ls_strategy="armijo",
    )
    res = solvers.solve(problem, cfg, xs_init=xs_init, us_init=us_init)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    qN = res.xs[-1][: model.nq]
    _, p = rbd.frame_placement(model, qN, model.frame_id("ee"))
    print("ee error:", float(jnp.linalg.norm(p - p_target)))
