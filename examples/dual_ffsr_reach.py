"""Dual-arm free-floating space robot (FFSR) reach — the reference fork's
vendored application workload, accelerator-native.

Counterpart of ``dual-FFSR_ProxDDP/main3.py``: a free-flyer satellite bus
with two 7-DOF arms in zero gravity performs a coordinated reach with both
tool frames, under torque box bounds and (optionally) a capsule obstacle
constraint. The base is unactuated (actuation matrix selects the 14 arm
torques only), so every arm motion exchanges momentum with the bus — the
solver must coordinate base drift and arm trajectories, exactly the coupling
the vendored app studies.

The reference app builds the model from MJCF via Pinocchio and uses
``aligator.FramePlacementResidual`` + control bounds + FCL collision pairs;
here the model is parsed from the *same vendored MJCF* with the REAL
masses/inertias/armature (``modelling/multibody/mjcf.load_mjcf``, validated
against MuJoCo in ``tests/test_ingestion.py``) when the file is available,
with the hand-authored :func:`make_dual_arm_ffsr` (Panda-chain arms) as a
fallback; the residual/constraint zoo is this framework's.
"""

import os

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.extra_residuals import FrameCollisionResidual
from aligator_tpu.modelling.multibody.residuals import (
    FramePlacementResidual,
    FrameVelocityResidual,
)
from aligator_tpu.modelling.multibody.robots import (
    FFSR_Q_ARM1,
    FFSR_Q_ARM2,
    make_dual_arm_ffsr,
)


FFSR_MJCF = "/root/reference/dual-FFSR_ProxDDP/xml/dual_arm_space_robot.xml"


def load_ffsr_model(use_mjcf=None):
    """The FFSR model: parsed from the vendored MJCF (real parameters,
    free-flyer bus, grasp object dropped) when available, else the
    hand-authored nominal model. Returns (model, tool frame names, u_max):
    torque bounds are the MJCF's ``actuatorfrcrange`` ±500 for the real
    model, Panda-scale efforts for the nominal one."""
    if use_mjcf is None:
        use_mjcf = os.path.exists(FFSR_MJCF)
    if use_mjcf:
        from aligator_tpu.modelling.multibody.mjcf import load_mjcf

        model, _ = load_mjcf(
            FFSR_MJCF, root_joint="freeflyer", skip_bodies=("object",)
        )
        return model, ("grip1", "grip2"), [500.0] * 14
    return (
        make_dual_arm_ffsr(),
        ("arm1_tool", "arm2_tool"),
        [87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0] * 2,
    )


def create_ffsr_problem(
    nsteps=60,
    timestep=0.05,
    with_collision=False,
    with_self_collision=False,
    dtype=jnp.float64,
    use_mjcf=None,
):
    """Coordinated dual-tool reach from the vendored app's nominal arm
    postures to displaced world-frame target poses."""
    model, (tool1, tool2), u_max_list = load_ffsr_model(use_mjcf)
    nv = model.nv  # 20
    nu = nv - 6  # 14: base unactuated
    space = model.phase_space()

    actuation = jnp.eye(nv, nu, -6, dtype=dtype)
    dyn_ode = MultibodyFreeFwdDynamics(model=model, actuation=actuation)
    dyn = IntegratorSemiImplEuler(
        ode=dyn_ode, timestep=jnp.asarray(timestep, dtype)
    )

    q0 = model.neutral().astype(dtype)
    q0 = q0.at[7:14].set(jnp.asarray(FFSR_Q_ARM1, dtype))
    q0 = q0.at[14:21].set(jnp.asarray(FFSR_Q_ARM2, dtype))
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])

    # reachable targets: FK of a perturbed arm posture (base at neutral),
    # so the task demands coordinated base/arm momentum exchange
    dq = jnp.zeros_like(q0)
    dq = dq.at[jnp.array([8, 10, 12])].set(jnp.asarray([0.35, -0.3, 0.25], dtype))
    dq = dq.at[jnp.array([15, 17, 19])].set(jnp.asarray([-0.3, 0.3, -0.2], dtype))
    q_tgt = q0 + dq
    targets = {}
    for name in (tool1, tool2):
        R_t, p_t = rbd.frame_placement(model, q_tgt, model.frame_id(name))
        targets[name] = (R_t.astype(dtype), p_t.astype(dtype))

    pose_res = {
        name: FramePlacementResidual(
            model=model, R_ref=targets[name][0], p_ref=targets[name][1],
            frame_id=model.frame_id(name),
        )
        for name in targets
    }
    vel_res = {
        name: FrameVelocityResidual(
            model=model, v_ref=jnp.zeros((6,), dtype),
            frame_id=model.frame_id(name),
        )
        for name in targets
    }

    w6 = jnp.eye(6, dtype=dtype)
    rcost = core.CostStack.create(
        core.QuadraticResidualCost(
            residual=pose_res[tool1], weights=5.0 * w6 * timestep
        ),
        core.QuadraticResidualCost(
            residual=pose_res[tool2], weights=5.0 * w6 * timestep
        ),
        core.QuadraticControlCost(1e-3 * jnp.eye(nu, dtype=dtype) * timestep),
    )
    term_cost = core.CostStack.create(
        core.QuadraticResidualCost(
            residual=pose_res[tool1], weights=200.0 * w6
        ),
        core.QuadraticResidualCost(
            residual=pose_res[tool2], weights=200.0 * w6
        ),
        core.QuadraticResidualCost(
            residual=vel_res[tool1], weights=20.0 * w6
        ),
        core.QuadraticResidualCost(
            residual=vel_res[tool2], weights=20.0 * w6
        ),
    )

    # torque bounds (the app's --bounds flag)
    u_max = jnp.asarray(u_max_list, dtype)
    constraints = [
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(lower=-u_max, upper=u_max),
        ),
    ]
    if with_collision:
        # capsule obstacle ahead of the bus (the app's box obstacle, here a
        # capsule as in frame-collision.hpp); keep arm-1 tool clear of it
        seg_a = jnp.asarray(targets[tool1][1], dtype) + jnp.array(
            [0.3, 0.0, -0.5], dtype
        )
        seg_b = seg_a + jnp.array([0.0, 0.0, 1.0], dtype)
        coll = FrameCollisionResidual(
            model=model, seg_a=seg_a, seg_b=seg_b,
            radius=jnp.asarray(0.15, dtype),
            frame_id=model.frame_id(tool1),
        )
        constraints.append((coll, core.NegativeOrthant()))
    if with_self_collision:
        # the app's --collisions flag: keep the two hand capsules apart
        from aligator_tpu.modelling.multibody.extra_residuals import (
            LinkCollisionResidual,
        )

        z = jnp.array([0.0, 0.0, 1.0], dtype)
        self_coll = LinkCollisionResidual(
            model=model,
            axis1=z, half_len1=jnp.asarray(0.12, dtype),
            radius1=jnp.asarray(0.06, dtype),
            axis2=z, half_len2=jnp.asarray(0.12, dtype),
            radius2=jnp.asarray(0.06, dtype),
            offset1=jnp.zeros(3, dtype), offset2=jnp.zeros(3, dtype),
            margin=jnp.asarray(0.02, dtype),
            frame_id1=model.frame_id(tool1),
            frame_id2=model.frame_id(tool2),
        )
        constraints.append((self_coll, core.NegativeOrthant()))

    stage = core.make_stage(rcost, dyn, space, nu, tuple(constraints))
    problem = core.make_problem(x0, stage, nsteps, term_cost)
    return problem, model, targets


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from aligator_tpu import solvers

    problem, model, targets = create_ffsr_problem(nsteps=60)
    # monotone Armijo: the nonmonotone default admits a Gauss-Newton limit
    # cycle on this strongly-coupled rotation task
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=120, rollout="nonlinear",
        ls_strategy="armijo",
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    qN = res.xs[-1][: model.nq]
    for name, (R_t, p_t) in targets.items():
        R, p = rbd.frame_placement(model, qN, model.frame_id(name))
        print(
            f"{name}: pos err {float(jnp.linalg.norm(p - p_t)):.2e}  "
            f"rot err {float(jnp.linalg.norm(R - R_t)):.2e}"
        )
    # free-floating physics: the unactuated base must drift to conserve
    # momentum (initial momentum is zero, no external forces)
    base_drift = float(jnp.linalg.norm(res.xs[-1][:3] - res.xs[0][:3]))
    print("base drift:", base_drift)
    print("max |tau|:", float(np.max(np.abs(np.asarray(res.us)))))
