"""Talos-class humanoid walking (the reference's headline whole-body
workload, ``examples/talos_walk.py``: reduced Talos nq=29/nv=28/nu=22,
6D sole contacts, double/single-support schedule, dt=0.01, N=220).

Accelerator-first re-design of the stage structure: the reference builds 220
heterogeneous C++ stages (per-phase dynamics objects + per-stage constraint
stacks); here ONE stage pytree is replicated and the schedule lives entirely
in stacked stage-parameter leaves —
  * contact activity masks (2,) per stage drive the 6D constrained dynamics,
  * the swing-foot tracking cost has stage-varying weight & target
    (weight 0 while the foot is in stance),
so the whole horizon is a single vmapped evaluate + scan solve with no
shape heterogeneity. Touch-down is enforced through the high-weight swing
target at the end of each swing phase (the reference instead adds equality
constraints on the post-swing stage).

Run: python examples/talos_walk.py [--full]   (--full = the N=220 protocol)
"""

import sys
import time

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import replace
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.multibody.contact import MultibodyConstraintFwdDynamics
from aligator_tpu.modelling.multibody.humanoid import (
    actuation_matrix,
    effort_limits,
    half_sitting,
    make_humanoid,
)
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual


def walk_schedule(t_ds, t_ss, swing_apex, dtype):
    """Contact activity (N, 2) [left, right], per-foot swing weight (N, 2)
    and swing-foot z-targets (N, 2) following the reference's sine profile
    (``talos_walk.py`` ``ztraj``)."""
    acts, w_swing, z_tgt = [], [], []

    def phase(n, act, swing_foot=None):
        for k in range(n):
            acts.append(act)
            if swing_foot is None:
                w_swing.append([0.0, 0.0])
                z_tgt.append([0.0, 0.0])
            else:
                w = [0.0, 0.0]
                z = [0.0, 0.0]
                w[swing_foot] = 1.0
                z[swing_foot] = swing_apex * jnp.sin(jnp.pi * (k + 1) / t_ss)
                w_swing.append(w)
                z_tgt.append(z)

    phase(t_ds, [1.0, 1.0])
    phase(t_ss, [1.0, 0.0], swing_foot=1)  # LEFT support: right foot swings
    phase(t_ds, [1.0, 1.0])
    phase(t_ss, [0.0, 1.0], swing_foot=0)  # RIGHT support: left foot swings
    phase(t_ds, [1.0, 1.0])
    return (
        jnp.asarray(acts, dtype),
        jnp.asarray(w_swing, dtype),
        jnp.asarray(z_tgt, dtype),
    )


def create_talos_walk_problem(
    t_ds=20, t_ss=80, timestep=0.01, swing_apex=0.1, dtype=jnp.float64,
    w_foot=1e5, bounds=True,
):
    model = make_humanoid()
    space = model.phase_space()
    nv, nu = model.nv, model.nv - 6
    soles = (model.frame_id("left_sole"), model.frame_id("right_sole"))

    q0 = half_sitting(model).astype(dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])
    sole_pos = [rbd.frame_placement(model, q0, f)[1] for f in soles]

    sched, w_swing, z_tgt = walk_schedule(t_ds, t_ss, swing_apex, dtype)
    N = sched.shape[0]

    B = actuation_matrix(model).astype(dtype)
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=B, active=jnp.ones((2,), dtype),
        contact_frames=soles, contact_dims=(6, 6), kd=50.0, prox_mu=1e-9,
    )
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    # reference weight profile (talos_walk.py w_x): base pos free, base ori
    # pinned, legs 1, torso 1e3, arms 1e2; velocity weights below.
    w_x = jnp.concatenate(
        [
            jnp.zeros(3), jnp.full(3, 1e4),
            jnp.full(12, 1.0), jnp.full(2, 1e3), jnp.full(8, 1e2),
            jnp.full(6, 1e2), jnp.full(12, 10.0), jnp.full(2, 1e3),
            jnp.full(8, 10.0),
        ]
    ).astype(dtype)
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, jnp.diag(w_x) * timestep),
        core.QuadraticControlCost(1e-3 * jnp.eye(nu, dtype=dtype) * timestep),
        # per-foot swing tracking (weight gated by the schedule)
        core.QuadraticResidualCost(
            FrameTranslationResidual(
                model=model, frame_id=soles[0], p_ref=sole_pos[0]
            ),
            weights=w_foot * timestep * jnp.eye(3, dtype=dtype),
        ),
        core.QuadraticResidualCost(
            FrameTranslationResidual(
                model=model, frame_id=soles[1], p_ref=sole_pos[1]
            ),
            weights=w_foot * timestep * jnp.eye(3, dtype=dtype),
        ),
    )
    term_cost = core.QuadraticStateCost(x0, 100.0 * jnp.diag(w_x))

    constraints = ()
    if bounds:
        umax = effort_limits().astype(dtype)
        constraints = (
            (core.ControlErrorResidual(jnp.zeros(nu, dtype)),
             core.BoxConstraint(-umax, umax)),
        )

    stage = core.make_stage(rcost, dyn, space, nu, constraints=constraints)
    stages = core.replicate_stage(stage, N)

    # schedule → stacked leaves: contact masks + swing-cost weights/targets
    foot_costs = []
    for k in range(2):
        c = stages.cost.costs[2 + k]
        tgt = jnp.tile(sole_pos[k][None, :], (N, 1)).at[:, 2].add(z_tgt[:, k])
        W = (w_foot * timestep) * w_swing[:, k][:, None, None] * jnp.eye(
            3, dtype=dtype
        )
        foot_costs.append(
            replace(c, residual=replace(c.residual, p_ref=tgt), weights=W)
        )
    stages = replace(
        stages,
        dynamics=replace(
            stages.dynamics, ode=replace(stages.dynamics.ode, active=sched)
        ),
        cost=replace(
            stages.cost,
            costs=(stages.cost.costs[0], stages.cost.costs[1], *foot_costs),
        ),
    )
    problem = core.make_problem(x0, stage, N, term_cost, stages=stages)
    return problem, model, sched


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    full = "--full" in sys.argv
    t_ds, t_ss = (20, 80) if full else (4, 10)
    t0 = time.time()
    problem, model, sched = create_talos_walk_problem(t_ds=t_ds, t_ss=t_ss)
    print(f"build: {time.time() - t0:.1f}s  N={sched.shape[0]} nv={model.nv}")

    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-8, max_iters=100 if full else 30,
        rollout="linear", ls_strategy="filter",
        force_initial_condition=True,
    )
    t0 = time.time()
    res = solvers.solve(problem, cfg)
    jax.block_until_ready(res.xs)
    print(f"solve(+compile): {time.time() - t0:.1f}s")
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    zs = res.xs[:, 2]
    print("base z range: [%.3f, %.3f]" % (zs.min(), zs.max()))
