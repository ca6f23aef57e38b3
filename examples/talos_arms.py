"""Talos upper-body dual-arm reach (counterpart of reference
``examples/talos_arms.py``): fixed-base torso + two 4-dof arms under free
forward dynamics, left-gripper Cartesian target, torque box constraints."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.humanoid import (
    make_humanoid_upper_body,
    upper_body_effort_limits,
)
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual


def create_talos_arms_problem(
    nsteps=80, timestep=0.01, bounds=True, dtype=jnp.float64
):
    model = make_humanoid_upper_body()
    nv = model.nv
    space = model.phase_space()
    nu = nv  # fully actuated (reference talos_arms.py:26 nu = nv)

    ode = MultibodyFreeFwdDynamics(model=model, actuation=jnp.eye(nv, dtype=dtype))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x0 = space.neutral().astype(dtype)
    q0 = x0[: model.nq]

    # target = neutral left-gripper position + a forward/up offset (the
    # reference's absolute target [0.6, 0.4, 1.4] expressed relative to its
    # own base frame; ours is torso-rooted at the origin)
    lg = model.frame_id("left_gripper")
    _, p0 = rbd.frame_placement(model, q0, lg)
    p_target = p0 + jnp.array([0.25, 0.1, 0.35], dtype)
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target, frame_id=lg)

    # state reg: torso posture weighted, velocities lightly
    # (reference talos_arms.py:46-49)
    w_x = jnp.concatenate(
        [jnp.full(2, 1.0), jnp.full(nv - 2, 0.01), jnp.full(nv, 1e-4)]
    )
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, jnp.diag(w_x).astype(dtype) * timestep),
        core.QuadraticControlCost(1e-4 * jnp.eye(nu, dtype=dtype) * timestep),
        core.QuadraticResidualCost(
            residual=frame_res,
            weights=10.0 * jnp.eye(3, dtype=dtype) * (0.01 * timestep),
        ),
    )
    term_cost = core.CostStack.create(
        core.QuadraticStateCost(x0, jnp.diag(w_x).astype(dtype)),
        core.QuadraticResidualCost(
            residual=frame_res, weights=10.0 * jnp.eye(3, dtype=dtype)
        ),
    )

    constraints = ()
    if bounds:
        lim = upper_body_effort_limits().astype(dtype)
        constraints = (
            (
                core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
                core.BoxConstraint(lower=-lim, upper=lim),
            ),
        )
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    problem = core.make_problem(x0, stage, nsteps, term_cost)
    return problem, model, p_target


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model, p_target = create_talos_arms_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-5, mu_init=1e-3, max_iters=100, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    qN = res.xs[-1][: model.nq]
    _, p = rbd.frame_placement(model, qN, model.frame_id("left_gripper"))
    print("gripper error:", float(jnp.linalg.norm(p - p_target)))
