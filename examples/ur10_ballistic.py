"""UR10 payload throw ("ballistic") — grasp, swing, release, hit a target.

Counterpart of the reference ``examples/ur10_ballistic.py``: a UR10 arm
rigidly grasping a free-flying payload (the "mug") must throw it so the
payload's ballistic flight lands on a target point, under torque and
joint-velocity limits, with a terminal EQUALITY constraint on the payload
position (``problem.addTerminalConstraint(create_term_constraint(...))``,
ur10_ballistic.py:372-375).

Accelerator-first re-design of the reference's model-switch structure:

* the reference builds TWO dynamics objects — constrained
  (``MultibodyConstraintFwdDynamics`` with a 6D ``RigidConstraintModel``
  tool↔mug, ur10_ballistic.py:131-165,225-238) for the grasp phase and
  free (``MultibodyFreeFwdDynamics``) after release — and a heterogeneous
  stage list (``create_stage(k <= t_contact)``, :363-368);
* here ONE composite model (``make_ur10_with_payload``: arm + free-flyer
  payload as a two-root forest) and ONE stage pytree carry the whole
  schedule: the grasp is a 6D body-body LOOP constraint (``contact.py``
  ``contact_frames2``) whose stage-stacked ``active`` flag IS the model
  switch — active ⇒ constrained dynamics, inactive ⇒ free fall, with no
  shape heterogeneity and a single vmapped evaluate.

Run: python examples/ur10_ballistic.py [--full]   (--full = N=200, dt=0.01)
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import replace
from aligator_tpu.core.functions import FunctionSlice, StateErrorResidual
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.contact import (
    MultibodyConstraintFwdDynamics,
    underactuated_constrained_rnea,
)
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual
from aligator_tpu.modelling.multibody.robots import (
    make_ur10_with_payload,
    ur10_effort_limits,
)

# reference ur10_ballistic.py:34 initial arm posture
Q0_ARM = np.array(
    [0.0, np.deg2rad(-120), 2 * np.pi / 3, np.deg2rad(-45), 0.0, 0.0]
)
TARGET_POS = np.array([1.0, 1.5, 0.0])  # ur10_ballistic.py:199
UR10_VEL_LIMITS = np.array([2.16, 2.16, 3.15, 3.2, 3.2, 3.2])


def create_ur10_ballistic_problem(
    nsteps=200, timestep=0.01, t_contact_frac=0.4, dtype=jnp.float64,
    target_pos=TARGET_POS,
):
    model = make_ur10_with_payload()
    space = model.phase_space()
    nv, nu = model.nv, 6
    ee, mug = model.frame_id("ee"), model.frame_id("mug")

    # initial state: arm at the reference posture, payload AT the tool
    q_tmp = jnp.asarray(
        np.concatenate([Q0_ARM, [0, 0, 0], [0, 0, 0, 1]]), dtype
    )
    _, p_ee = rbd.frame_placement(model, q_tmp, ee)
    q0 = q_tmp.at[6:9].set(p_ee)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])

    B = jnp.concatenate(
        [jnp.eye(nu, dtype=dtype), jnp.zeros((6, nu), dtype)], axis=0
    )

    # grasp inverse dynamics for the control regularization center
    # (reference underactuatedConstrainedInverseDynamics, :243-252)
    u0, _ = underactuated_constrained_rnea(
        model, q0, jnp.zeros((nv,), dtype), B, (ee,),
        contact_dims=(6,), contact_frames2=(mug,),
    )

    # position + velocity Baumgarte on the grasp with the REFERENCE's
    # corrector gains (Kp=1e-3, Kd=2*sqrt(Kp) on the
    # RigidConstraintModel corrector, ur10_ballistic.py:167-170). The
    # gains matter a lot (measured): without the position term the AL
    # loop is trajectory-chaotic (dual stalls anywhere in 5e-4..5); with
    # kp=1 it over-stiffens (prim 16); with the reference's 1e-3 the
    # solve converges cleanly (prim 4e-6 in 400 iterations). The
    # relative-position reference is the grasp offset at t=0
    # (p_ee - p_mug = 0 by construction of q0).
    kp_grasp = 1e-3
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=B, active=jnp.ones((1,), dtype),
        contact_frames=(ee,), contact_dims=(6,), contact_frames2=(mug,),
        prox_mu=1e-9, kp=kp_grasp, kd=2.0 * float(np.sqrt(kp_grasp)),
        p_refs=jnp.zeros((1, 3), dtype),
    )
    dyn = IntegratorSemiImplEuler(
        ode=ode, timestep=jnp.asarray(timestep, dtype)
    )

    # running cost (reference create_running_cost, :277-292): state reg
    # with the payload rows zeroed, control reg around u0
    w_x = np.concatenate([[1e-3] * nv, [0.1] * nv])
    w_x[6:12] = 0.0  # payload configuration tangent
    w_x[nv + 6 : nv + 12] = 0.0  # payload velocity
    rcost = core.CostStack.create(
        core.QuadraticStateCost(
            x0, jnp.diag(jnp.asarray(w_x, dtype)) * timestep
        ),
        core.QuadraticControlCost(
            1e-5 * jnp.eye(nu, dtype=dtype) * timestep, target=u0
        ),
    )
    # terminal cost (reference create_term_cost, :294-309)
    w_xf = np.zeros(2 * nv)
    w_xf[:6] = 1e-4
    w_xf[nv + 6 :] = 1e-6
    term_cost = core.QuadraticStateCost(x0, jnp.diag(jnp.asarray(w_xf, dtype)))

    # stage constraints: torque box + arm joint-velocity box
    # (reference get_torque_limit_constraint / get_velocity_limit_constraint)
    eff = ur10_effort_limits().astype(dtype)
    vlim = jnp.asarray(UR10_VEL_LIMITS, dtype)
    vel_fn = FunctionSlice(
        func=StateErrorResidual(target=space.neutral().astype(dtype)),
        indices=tuple(range(nv, nv + 6)),
    )
    constraints = (
        (core.ControlErrorResidual(jnp.zeros(nu, dtype)),
         core.BoxConstraint(-eff, eff)),
        (vel_fn, core.BoxConstraint(-vlim, vlim)),
    )

    # terminal constraints: payload position == target (EQUALITY) +
    # arm velocity box (reference :372-375)
    mug_pos = FrameTranslationResidual(
        model=model, frame_id=mug, p_ref=jnp.asarray(target_pos, dtype)
    )
    term_constraints = (
        (mug_pos, core.EqualityConstraint()),
        (vel_fn, core.BoxConstraint(-vlim, vlim)),
    )

    stage = core.make_stage(rcost, dyn, space, nu, constraints=constraints)
    N = nsteps
    stages = core.replicate_stage(stage, N)
    # the model switch: grasp active for the first 40% of the horizon
    t_contact = int(t_contact_frac * N)
    sched = (jnp.arange(N) <= t_contact).astype(dtype)[:, None]
    stages = replace(
        stages,
        dynamics=replace(
            stages.dynamics, ode=replace(stages.dynamics.ode, active=sched)
        ),
    )
    problem = core.make_problem(
        x0, stage, N, term_cost, term_constraints=term_constraints,
        stages=stages,
    )
    return problem, model, u0, sched


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    full = "--full" in sys.argv
    nsteps, dt_ = (200, 0.01) if full else (80, 0.025)
    t0 = time.time()
    problem, model, u0, sched = create_ur10_ballistic_problem(
        nsteps=nsteps, timestep=dt_
    )
    print(f"build: {time.time() - t0:.1f}s N={nsteps} nv={model.nv}")

    us_init = jnp.tile(u0[None], (nsteps, 1))
    from aligator_tpu.utils.rollout import rollout

    xs_init = rollout(
        problem.stages.dynamics, problem.space, problem.x0, us_init
    )
    # measured (CPU fp64, reference corrector gains): converges in ~400
    # iterations to prim 4e-6 / dual 1e-3, payload on target, torque
    # limits satisfied.
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, dual_tol=1e-3, mu_init=1e-2, max_iters=400,
        rollout="linear", ls_strategy="filter",
    )
    t0 = time.time()
    res = solvers.solve(problem, cfg, xs_init=xs_init, us_init=us_init)
    jax.block_until_ready(res.xs)
    print(f"solve(+compile): {time.time() - t0:.1f}s")
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    p_final = res.xs[-1][6:9]
    print("payload final pos:", np.asarray(p_final).round(4),
          "target:", TARGET_POS)
