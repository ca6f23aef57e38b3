"""UR5 reach over a table with collision keep-outs.

Counterpart of the reference's UR5 table variant (``examples/ur5_reach.py``
with a coal::Halfspace table via ``frame-collision.hpp:18``): the
end-effector capsule must stay above the table plane, and a box obstacle on
the table must be avoided, while reaching a Cartesian target close to the
table surface. Exercises the general collision-geometry residual pairs
(``modelling/multibody/geometry.py``) end-to-end through ProxDDP.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody import geometry as geo
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual
from aligator_tpu.modelling.multibody.robots import make_ur5

TABLE_HEIGHT = 0.15
EE_RADIUS = 0.04


def create_ur5_table_problem(
    nsteps=40, timestep=0.05, tau_bound=80.0, dtype=jnp.float64,
    with_box=True,
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

    # target just above the table surface
    p_target = jnp.array([0.45, 0.25, TABLE_HEIGHT + EE_RADIUS + 0.03], dtype)
    ee = model.frame_id("ee")
    frame_res = FrameTranslationResidual(model=model, p_ref=p_target, frame_id=ee)

    w_u = 1e-4 * jnp.eye(nu, dtype=dtype)
    w_v = 1e-2 * jnp.eye(nv, dtype=dtype)

    def vel_cost_weights():
        W = jnp.zeros((2 * nv, 2 * nv), dtype)
        return W.at[nv:, nv:].set(w_v)

    rcost = core.CostStack.create(
        core.QuadraticResidualCost(
            residual=frame_res, weights=10.0 * jnp.eye(3, dtype=dtype) * timestep
        ),
        core.QuadraticControlCost(w_u * timestep),
        core.QuadraticStateCost(space.neutral(), vel_cost_weights() * timestep),
    )
    term_cost = core.QuadraticResidualCost(
        residual=frame_res, weights=200.0 * jnp.eye(3, dtype=dtype)
    )

    # ee capsule must stay above the table plane z = TABLE_HEIGHT
    table = geo.FrameHalfspaceResidual(
        model=model,
        normal=jnp.array([0.0, 0.0, 1.0], dtype),
        plane_offset=jnp.asarray(TABLE_HEIGHT, dtype),
        offset=jnp.zeros(3, dtype),
        radius=jnp.asarray(EE_RADIUS, dtype),
        axis=jnp.array([0.0, 0.0, 1.0], dtype),
        half_len=jnp.asarray(0.06, dtype),
        margin=jnp.asarray(0.0, dtype),
        frame_id=ee,
    )
    constraints = [
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=-tau_bound * jnp.ones((nu,), dtype),
                upper=tau_bound * jnp.ones((nu,), dtype),
            ),
        ),
        (table, core.NegativeOrthant()),
    ]
    if with_box:
        # box obstacle sitting on the table between start and target
        box = geo.FrameBoxResidual(
            model=model,
            box_center=jnp.array([0.35, 0.0, TABLE_HEIGHT + 0.1], dtype),
            box_rot=jnp.eye(3, dtype=dtype),
            half_extents=jnp.array([0.08, 0.08, 0.1], dtype),
            offset=jnp.zeros(3, dtype),
            radius=jnp.asarray(EE_RADIUS, dtype),
            margin=jnp.asarray(0.01, dtype),
            frame_id=ee,
        )
        constraints.append((box, core.NegativeOrthant()))

    stage = core.make_stage(rcost, dyn, space, nu, tuple(constraints))
    # elbow-up start: the ee begins above the table (neutral q puts it at
    # z ≈ -0.005, below the plane, which would make stage 0 infeasible)
    q0 = jnp.zeros(model.nq, dtype).at[1].set(-1.2).at[2].set(1.6)
    x0 = jnp.concatenate([q0, jnp.zeros(model.nv, dtype)])
    return core.make_problem(x0, stage, nsteps, term_cost), model, p_target


def main():
    from aligator_tpu import solvers
    from aligator_tpu.modelling.multibody import model as rbd

    problem, model, p_target = create_ur5_table_problem(nsteps=30)
    cfg = solvers.ProxDDPConfig(tol=1e-4, mu_init=1e-2, max_iters=100)
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    qs = res.xs[:, : model.nq]
    zs = jax.vmap(
        lambda q: rbd.frame_placement(model, q, model.frame_id("ee"))[1][2]
    )(qs)
    print("min ee z over trajectory:", float(jnp.min(zs)),
          "(table at", TABLE_HEIGHT, ")")
    _, p_f = rbd.frame_placement(model, qs[-1], model.frame_id("ee"))
    print("final ee error:", float(jnp.linalg.norm(p_f - p_target)))


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    main()
