"""UR5 end-effector reach with joint torque limits.

Counterpart of the reference ``examples/ur5_reach.py`` (one of the
BASELINE.md parity configs): drive the UR5's end effector to a Cartesian
target with a quadratic task-space cost, control regularization, and box
bounds on the torques.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.modelling.multibody.residuals import FrameTranslationResidual
from aligator_tpu.modelling.multibody.robots import make_ur5


def create_ur5_problem(
    nsteps=40, timestep=0.05, tau_bound=80.0, dtype=jnp.float64,
    table_height=None,
):
    """``table_height``: optional halfspace constraint p_z(ee) >= h at every
    stage (the reference's ur5 table-halfspace variant)."""
    model = make_ur5()
    nv = model.nv
    space = model.phase_space()
    nu = nv

    dyn_ode = MultibodyFreeFwdDynamics(
        model=model, actuation=jnp.eye(nv, dtype=dtype)
    )
    dyn = IntegratorSemiImplEuler(ode=dyn_ode, timestep=jnp.asarray(timestep, dtype))

    p_target = jnp.array([0.4, 0.3, 0.4], dtype)
    ee = model.frame_id("ee")

    w_frame = 10.0 * jnp.eye(3, dtype=dtype)
    w_u = 1e-4 * jnp.eye(nu, dtype=dtype)
    w_v = 1e-2 * jnp.eye(nv, dtype=dtype)

    frame_res = FrameTranslationResidual(model=model, p_ref=p_target, frame_id=ee)

    def vel_cost_weights():
        W = jnp.zeros((2 * nv, 2 * nv), dtype)
        return W.at[nv:, nv:].set(w_v)

    rcost = core.CostStack.create(
        core.QuadraticResidualCost(residual=frame_res, weights=w_frame * timestep),
        core.QuadraticControlCost(w_u * timestep),
        core.QuadraticStateCost(space.neutral(), vel_cost_weights() * timestep),
    )
    term_cost = core.QuadraticResidualCost(
        residual=frame_res, weights=100.0 * jnp.eye(3, dtype=dtype)
    )

    constraints = []
    if tau_bound is not None:
        constraints.append(
            (
                core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
                core.BoxConstraint(
                    lower=-tau_bound * jnp.ones((nu,), dtype),
                    upper=tau_bound * jnp.ones((nu,), dtype),
                ),
            )
        )
    if table_height is not None:
        from aligator_tpu.core.functions import LinearFunctionComposition

        # h - p_z(ee) = -r_z + (h - p_target_z) <= 0  (stay above the table)
        above_table = LinearFunctionComposition(
            func=frame_res,
            A=jnp.array([[0.0, 0.0, -1.0]], dtype),
            b=jnp.array([table_height - p_target[2]], dtype),
        )
        constraints.append((above_table, core.NegativeOrthant()))

    stage = core.make_stage(rcost, dyn, space, nu, tuple(constraints))
    x0 = space.neutral()
    return core.make_problem(x0, stage, nsteps, term_cost), model, p_target


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers
    from aligator_tpu.modelling.multibody import model as rbd

    problem, model, p_target = create_ur5_problem(nsteps=30)
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=100, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    qN = res.xs[-1][: model.nq]
    _, pN = rbd.frame_placement(model, qN, model.frame_id("ee"))
    print("final ee pos:", pN, "target:", p_target)
    print("reach error:", float(jnp.linalg.norm(pN - p_target)))
    print("max |tau|:", float(jnp.max(jnp.abs(res.us))))
