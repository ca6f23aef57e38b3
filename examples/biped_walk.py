"""Biped walking with an alternating contact schedule (the Talos-walk-class
workload of the reference, ``examples/talos_walk.py`` — here on a compact
biped so the example stays tractable on CPU).

Phases: double support → single support (right foot lifted) → double
support → single support (left lifted) → double support, encoded purely as
stage-varying contact-activity masks; the base tracks a forward-advancing
reference."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import replace
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.multibody.contact import MultibodyConstraintFwdDynamics
from aligator_tpu.modelling.multibody.model import FREEFLYER, REVOLUTE, make_model


def make_biped(
    base_mass=10.0, thigh_mass=1.5, shank_mass=1.0, foot_y=0.1,
    upper_len=0.35, lower_len=0.35,
):
    joints = [
        dict(
            type=FREEFLYER, parent=-1, mass=base_mass, com=jnp.zeros(3),
            inertia=jnp.diag(jnp.array([0.1, 0.1, 0.05])),
        )
    ]
    frames = []
    for k, sy in enumerate((+1.0, -1.0)):  # left, right
        hip = dict(
            type=REVOLUTE, parent=0,
            placement_p=jnp.array([0.0, sy * foot_y, 0.0]),
            axis=jnp.array([0.0, 1.0, 0.0]),
            mass=thigh_mass, com=jnp.array([0.0, 0.0, -upper_len / 2]),
            inertia=jnp.diag(jnp.array([0.01, 0.01, 0.002])),
        )
        joints.append(hip)
        knee = dict(
            type=REVOLUTE, parent=len(joints) - 1,
            placement_p=jnp.array([0.0, 0.0, -upper_len]),
            axis=jnp.array([0.0, 1.0, 0.0]),
            mass=shank_mass, com=jnp.array([0.0, 0.0, -lower_len / 2]),
            inertia=jnp.diag(jnp.array([0.008, 0.008, 0.001])),
        )
        joints.append(knee)
        frames.append(
            dict(
                name=f"foot{k}", parent=len(joints) - 1,
                placement_p=jnp.array([0.0, 0.0, -lower_len]),
            )
        )
    return make_model(joints, frames)


def standing_q(model, height=0.62, bend=0.35):
    q = model.neutral().at[2].set(height)
    for leg in range(2):
        q = q.at[7 + 2 * leg].set(bend / 2)
        q = q.at[7 + 2 * leg + 1].set(-bend)
    return q


def create_biped_walk_problem(
    n_ds=6, n_ss=6, step_fwd=0.05, timestep=0.02, dtype=jnp.float64
):
    model = make_biped()
    space = model.phase_space()
    nv = model.nv
    nu = nv - 6
    feet = (model.frame_id("foot0"), model.frame_id("foot1"))

    # schedule: DS, SS(lift right=foot1), DS, SS(lift left=foot0), DS
    phases = [
        jnp.tile(jnp.array([1.0, 1.0], dtype), (n_ds, 1)),
        jnp.tile(jnp.array([1.0, 0.0], dtype), (n_ss, 1)),
        jnp.tile(jnp.array([1.0, 1.0], dtype), (n_ds, 1)),
        jnp.tile(jnp.array([0.0, 1.0], dtype), (n_ss, 1)),
        jnp.tile(jnp.array([1.0, 1.0], dtype), (n_ds, 1)),
    ]
    sched = jnp.concatenate(phases)
    N = sched.shape[0]

    B = jnp.zeros((nv, nu), dtype).at[6:, :].set(jnp.eye(nu, dtype=dtype))
    ode = MultibodyConstraintFwdDynamics(
        model=model, actuation=B, active=jnp.ones((2,), dtype),
        contact_frames=feet, kd=10.0,
    )
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    q0 = standing_q(model).astype(dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])

    # forward-advancing base reference
    xf = x0.at[0].add(step_fwd)
    t_frac = jnp.linspace(0.0, 1.0, N)[:, None]
    targets = x0[None, :] * (1 - t_frac) + xf[None, :] * t_frac

    w_x = jnp.diag(
        jnp.concatenate(
            [jnp.full(3, 50.0), jnp.full(3, 50.0), jnp.full(nu, 1.0),
             jnp.full(nv, 0.5)]
        )
    ).astype(dtype)
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, w_x * timestep),
        core.QuadraticControlCost(1e-4 * jnp.eye(nu, dtype=dtype) * timestep),
    )
    term_cost = core.QuadraticStateCost(xf, 10.0 * w_x)
    stage = core.make_stage(rcost, dyn, space, nu)

    stages = core.replicate_stage(stage, N)
    stages = replace(
        stages,
        dynamics=replace(
            stages.dynamics, ode=replace(stages.dynamics.ode, active=sched)
        ),
        cost=replace(
            stages.cost,
            costs=(
                replace(
                    stages.cost.costs[0],
                    residual=replace(stages.cost.costs[0].residual, target=targets),
                ),
                stages.cost.costs[1],
            ),
        ),
    )
    problem = core.make_problem(x0, stage, N, term_cost, stages=stages)
    return problem, model, sched


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model, sched = create_biped_walk_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear",
        ls_strategy="armijo",
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print("base x: start %.3f end %.3f (target +0.08)" % (res.xs[0, 0], res.xs[-1, 0]))
    print("base z range: [%.3f, %.3f]" % (res.xs[:, 2].min(), res.xs[:, 2].max()))
