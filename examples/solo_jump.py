"""Quadruped jump with contact schedule (counterpart of reference
``examples/solo_jump.py``): stance → flight → landing, with the contact
activity encoded as stage-varying parameters of the constrained dynamics
(the stacked-pytree version of the reference's per-phase stage models).
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import replace
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.multibody.contact import MultibodyConstraintFwdDynamics
from aligator_tpu.modelling.multibody.quadruped import (
    make_quadruped,
    standing_configuration,
)


def create_solo_jump_problem(
    n_stance=10, n_flight=8, n_land=10, timestep=0.02, dtype=jnp.float64
):
    model = make_quadruped()
    space = model.phase_space()
    nv = model.nv
    nu = nv - 6  # actuated joints only (underactuated base)
    N = n_stance + n_flight + n_land

    feet = tuple(model.frame_id(f"foot{k}") for k in range(4))
    B = jnp.zeros((nv, nu), dtype).at[6:, :].set(jnp.eye(nu, dtype=dtype))

    dyn = MultibodyConstraintFwdDynamics(
        model=model,
        actuation=B,
        active=jnp.ones((4,), dtype),
        contact_frames=feet,
        kd=10.0,
        prox_mu=1e-8,
    )
    base_dyn = IntegratorSemiImplEuler(ode=dyn, timestep=jnp.asarray(timestep, dtype))

    q0 = standing_configuration(model).astype(dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])

    # target: back on the stance pose at the end
    w_x = jnp.diag(
        jnp.concatenate(
            [
                jnp.full(3, 1.0),  # base position
                jnp.full(3, 1.0),  # base orientation
                jnp.full(nu, 0.1),  # joints
                jnp.full(nv, 0.01),  # velocities
            ]
        )
    ).astype(dtype)
    # during flight, reward base height: target x with z bumped up
    x_up = x0.at[2].add(0.25)

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, w_x * timestep),
        core.QuadraticControlCost(1e-4 * jnp.eye(nu, dtype=dtype) * timestep),
    )
    term_cost = core.QuadraticStateCost(x0, 10.0 * w_x)

    stage = core.make_stage(rcost, base_dyn, space, nu)
    stages = core.replicate_stage(stage, N)

    # contact schedule: stance (all 4), flight (none), landing (all 4)
    sched = jnp.concatenate(
        [
            jnp.ones((n_stance, 4), dtype),
            jnp.zeros((n_flight, 4), dtype),
            jnp.ones((n_land, 4), dtype),
        ]
    )
    # flight-phase cost targets the elevated base
    targets = jnp.where(
        (jnp.arange(N) >= n_stance)[:, None] & (jnp.arange(N) < n_stance + n_flight)[:, None],
        x_up[None, :],
        x0[None, :],
    )

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
                    residual=replace(
                        stages.cost.costs[0].residual, target=targets
                    ),
                ),
                stages.cost.costs[1],
            ),
        ),
    )

    problem = core.make_problem(x0, stage, N, term_cost, stages=stages)
    return problem, model, (n_stance, n_flight, n_land)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model, (ns, nf, nl) = create_solo_jump_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    z = res.xs[:, 2]
    print("base height: start %.3f peak %.3f end %.3f" % (z[0], z.max(), z[-1]))
