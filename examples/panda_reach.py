"""Panda SE(3) reach with collision avoidance and torque limits.

Counterpart of the reference ``examples/panda_mujoco_test_se3_collision.py``
(a BASELINE.md parity config): drive the Panda flange to a full SE(3) target
pose with quadratic placement + velocity costs, capsule-collision avoidance
constraints on the flange and elbow against a vertical post, and box bounds
on the joint torques.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody.extra_residuals import FrameCollisionResidual
from aligator_tpu.modelling.multibody.residuals import (
    FramePlacementResidual,
    FrameVelocityResidual,
)
from aligator_tpu.modelling.multibody.robots import (
    PANDA_EFFORT_LIMIT,
    PANDA_Q_HOME,
    make_panda,
    make_panda_real,
)


def create_panda_problem(
    nsteps=50,
    timestep=0.02,
    with_collision=True,
    dtype=jnp.float64,
    real_model=True,
):
    """SE(3) reach to a pose across a vertical capsule obstacle (the
    reference constrains collision pairs found in the MuJoCo scene; here the
    obstacle is a post between the home pose and the target).

    ``real_model=True`` (default) runs on the *real* vendored Panda MJCF
    (``panda_nohand.xml``, the exact asset the reference example loads —
    real inertials + joint armature, MuJoCo-validated), falling back to the
    nominal :func:`make_panda` approximation when the asset is absent."""
    if real_model:
        try:
            model, _ = make_panda_real()
        except FileNotFoundError:
            model = make_panda()
    else:
        model = make_panda()
    nv = model.nv
    space = model.phase_space()
    nu = nv

    dyn_ode = MultibodyFreeFwdDynamics(
        model=model, actuation=jnp.eye(nv, dtype=dtype)
    )
    dyn = IntegratorSemiImplEuler(
        ode=dyn_ode, timestep=jnp.asarray(timestep, dtype)
    )

    ee = model.frame_id("ee")
    elbow = model.frame_id("elbow")

    # target pose: reach to the side, flange pointing down (reference sets
    # target_pos = (-0.5, 0.4, 0.6) with a quaternion-specified attitude)
    p_target = jnp.array([0.35, 0.45, 0.35], dtype)
    R_target = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], dtype
    )

    pose_res = FramePlacementResidual(
        model=model, R_ref=R_target, p_ref=p_target, frame_id=ee
    )
    vel_res = FrameVelocityResidual(
        model=model, v_ref=jnp.zeros((6,), dtype), frame_id=ee
    )

    w_pose = 10.0 * jnp.eye(6, dtype=dtype)
    w_u = 1e-4 * jnp.eye(nu, dtype=dtype)

    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=pose_res, weights=w_pose * timestep),
        core.QuadraticControlCost(w_u * timestep),
    )
    term_cost = core.CostStack.create(
        core.QuadraticResidualCost(
            residual=pose_res, weights=100.0 * jnp.eye(6, dtype=dtype)
        ),
        core.QuadraticResidualCost(
            residual=vel_res, weights=50.0 * jnp.eye(6, dtype=dtype)
        ),
    )

    constraints = [
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=jnp.asarray(-PANDA_EFFORT_LIMIT, dtype),
                upper=jnp.asarray(PANDA_EFFORT_LIMIT, dtype),
            ),
        ),
    ]
    if with_collision:
        # vertical capsule post between home and target
        post_a = jnp.array([0.25, 0.25, 0.0], dtype)
        post_b = jnp.array([0.25, 0.25, 0.9], dtype)
        for fid in (ee, elbow):
            coll = FrameCollisionResidual(
                model=model,
                seg_a=post_a,
                seg_b=post_b,
                radius=jnp.asarray(0.12, dtype),  # post radius + margin
                frame_id=fid,
            )
            constraints.append((coll, core.NegativeOrthant()))

    stage = core.make_stage(rcost, dyn, space, nu, tuple(constraints))
    q0 = jnp.asarray(PANDA_Q_HOME, dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])
    problem = core.make_problem(x0, stage, nsteps, term_cost)
    return problem, model, (R_target, p_target)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers
    from aligator_tpu.modelling.multibody import model as rbd

    problem, model, (R_t, p_t) = create_panda_problem(nsteps=50)
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=300, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    qN = res.xs[-1][: model.nq]
    R, p = rbd.frame_placement(model, qN, model.frame_id("ee"))
    print("final ee pos:", p, "target:", p_t)
    print("pos error:", float(jnp.linalg.norm(p - p_t)))
    print("rot error:", float(jnp.linalg.norm(R - R_t)))
    # minimum clearance to the post over the trajectory
    post_a, post_b = jnp.array([0.25, 0.25, 0.0]), jnp.array([0.25, 0.25, 0.9])

    def clearance(x):
        q = x[: model.nq]
        _, pe = rbd.frame_placement(model, q, model.frame_id("ee"))
        ab = post_b - post_a
        t = jnp.clip(jnp.dot(pe - post_a, ab) / jnp.dot(ab, ab), 0.0, 1.0)
        return jnp.linalg.norm(pe - (post_a + t * ab))

    dmin = jnp.min(jax.vmap(clearance)(res.xs))
    print("min ee clearance:", float(dmin), "(radius 0.12)")
    print("max |tau|:", float(jnp.max(jnp.abs(res.us))))
