"""Solo quadruped squatting ("bend") with all four feet in ground contact
(counterpart of reference ``examples/solo_bend.py``): the base tracks a
sinusoidal height profile while the constrained dynamics hold the feet
pinned — the contact-schedule-free sibling of ``solo_jump.py``.

The per-stage targets are a stage-varying parameter of the stacked state
cost (the pytree analog of the reference's per-stage target list,
reference ``solo_bend.py:54-67`` ``create_target``).
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


def create_solo_bend_problem(
    nsteps=40, timestep=0.01, freq=3.0, dtype=jnp.float64
):
    model = make_quadruped()
    space = model.phase_space()
    nv = model.nv
    nu = nv - 6

    feet = tuple(model.frame_id(f"foot{k}") for k in range(4))
    B = jnp.zeros((nv, nu), dtype).at[6:, :].set(jnp.eye(nu, dtype=dtype))

    ode = MultibodyConstraintFwdDynamics(
        model=model,
        actuation=B,
        active=jnp.ones((4,), dtype),
        contact_frames=feet,
        kd=10.0,
        prox_mu=1e-8,
    )
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    q0 = standing_configuration(model).astype(dtype)
    x0 = jnp.concatenate([q0, jnp.zeros((nv,), dtype)])
    z0 = x0[2]

    # base-height target: z(t) = 0.7 z0 + 0.4 z0 sin²(freq t), slight xy shift
    # (reference solo_bend.py:54-63)
    t = timestep * jnp.arange(nsteps, dtype=dtype)
    z_t = 0.7 * z0 + 0.4 * z0 * jnp.sin(freq * t) ** 2
    targets = jnp.tile(x0[None, :], (nsteps, 1))
    targets = targets.at[:, 0].set(-0.02)
    targets = targets.at[:, 1].set(0.03)
    targets = targets.at[:, 2].set(z_t)

    # base position weighted strongly, joints/velocities lightly
    # (reference solo_bend.py:73-76)
    w_x = jnp.diag(
        jnp.concatenate(
            [
                jnp.full(3, 2.0),
                jnp.full(3, 1e-3),
                jnp.full(nu, 1e-3),
                jnp.full(nv, 1e-3),
            ]
        )
    ).astype(dtype)

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x0, w_x * timestep),
        core.QuadraticControlCost(1e-3 * jnp.eye(nu, dtype=dtype) * timestep),
    )
    term_target = targets[-1]
    term_cost = core.QuadraticStateCost(term_target, 10.0 * w_x)

    stage = core.make_stage(rcost, dyn, space, nu)
    stages = core.replicate_stage(stage, nsteps)
    stages = replace(
        stages,
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
    problem = core.make_problem(x0, stage, nsteps, term_cost, stages=stages)
    return problem, model, targets


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model, targets = create_solo_bend_problem(nsteps=120)
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-2, max_iters=60, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    z = res.xs[:, 2]
    zt = targets[:, 2]
    print(
        "base z: start %.3f min %.3f max %.3f (target %.3f..%.3f)"
        % (z[0], z.min(), z.max(), zt.min(), zt.max())
    )
