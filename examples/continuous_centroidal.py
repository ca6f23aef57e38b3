"""Continuous-centroidal locomotion (counterpart of reference
``examples/continuous-centroidal.py``).

Same quadruped gait as ``centroidal_locomotion.py`` but on the *extended*
state x = (c, h, L, f₁..f₄) ∈ R²¹ with the control re-interpreted as force
rates (``ContinuousCentroidalFwdDynamics``): forces become smooth decision
trajectories, friction cones act on state slices through
``CentroidalWrapperResidual``, and the first/last stages pin zero force-rate,
zero linear acceleration and zero momentum as gated equalities (the reference
attaches those constraints to stages[0]/stages[-1] only,
``continuous-centroidal.py:249-258``; here a stage-varying
``core.GatedFunction`` gate does the same on stacked homogeneous stages).
"""

import jax
import jax.numpy as jnp
import numpy as np

from aligator_tpu import core, solvers
from aligator_tpu.modelling.centroidal import (
    AngularAccelerationResidual,
    AngularMomentumResidual,
    CentroidalAccelerationResidual,
    CentroidalCoMResidual,
    CentroidalFrictionConeResidual,
    CentroidalWrapperResidual,
    LinearMomentumResidual,
)
from aligator_tpu.modelling.dynamics.centroidal import (
    ContactMap,
    ContinuousCentroidalFwdDynamics,
)
from aligator_tpu.modelling.dynamics.ode import IntegratorEuler

MASS = 10.5
GRAVITY = np.array([0.0, 0.0, -9.81])
MU_FRICTION = 0.8
NK = 4  # LF, RF, LB, RB
NU = 3 * NK  # force rates
NX = 9 + NU  # (c, h, L, forces)
DT = 0.01
COM_INITIAL = np.array([0.1, 0.05, 0.15])


def make_schedule(T_ds=10, T_ss=40, T_tail=50, dtype=jnp.float64):
    """Reference gait cp1..cp7 (``continuous-centroidal.py:46-123``):
    double support → swing {LF, RB} → ds (stepped) → swing {RF, LB} → ds →
    swing {LF, RB} → final ds."""
    p0 = np.array(
        [[0.2, 0.1, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.0]]
    )
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.05
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.05
    phases = [
        (T_ds, [1, 1, 1, 1], p0),
        (T_ss, [0, 1, 1, 0], p0),
        (T_ds, [1, 1, 1, 1], p1),
        (T_ss, [1, 0, 0, 1], p1),
        (T_ds, [1, 1, 1, 1], p2),
        (T_ss, [0, 1, 1, 0], p2),
        (T_ds + T_tail, [1, 1, 1, 1], p2),
    ]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases])
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    com_final = points[-1].mean(axis=0)
    com_final[2] = COM_INITIAL[2]
    return jnp.asarray(active, dtype), jnp.asarray(points, dtype), com_final


def make_stage_at(active_t, points_t, w_force_t, g_first, g_last, dtype):
    """One stage of the stacked problem; ``w_force_t`` (NU,) weights the
    force-regularization state cost rows (fz ×100 at contact transitions,
    reference ``continuous-centroidal.py:177-181``); g_first/g_last gate the
    boundary equalities."""
    space = core.VectorSpace(NX)
    zero3 = jnp.zeros((3,), dtype)
    cmap = ContactMap(points=points_t, active=active_t)
    mass = jnp.asarray(MASS, dtype)
    grav = jnp.asarray(GRAVITY, dtype)
    ode = ContinuousCentroidalFwdDynamics(
        contact_map=cmap, mass=mass, gravity=grav
    )
    dyn = IntegratorEuler(ode=ode, timestep=jnp.asarray(DT, dtype))

    eye3 = jnp.eye(3, dtype=dtype)
    w_state = jnp.concatenate([jnp.zeros((9,), dtype), 1e-2 * w_force_t])
    lin_acc = CentroidalAccelerationResidual(
        contact_map=cmap, mass=mass, gravity=grav, a_ref=zero3
    )
    ang_acc = AngularAccelerationResidual(contact_map=cmap, ref=zero3)
    lin_mom = LinearMomentumResidual(h_ref=zero3)
    cost = core.CostStack.create(
        core.QuadraticCost.create(
            jnp.diag(w_state), 1e-4 * jnp.eye(NU, dtype=dtype)
        ),
        core.QuadraticResidualCost(
            residual=CentroidalWrapperResidual(inner=lin_mom),
            weights=10.0 * eye3,
        ),
        core.QuadraticResidualCost(
            residual=CentroidalWrapperResidual(inner=ang_acc),
            weights=0.1 * eye3,
        ),
        core.QuadraticResidualCost(
            residual=CentroidalWrapperResidual(inner=lin_acc),
            weights=0.1 * eye3,
        ),
    )

    cones = tuple(
        (
            CentroidalWrapperResidual(
                inner=CentroidalFrictionConeResidual(
                    mu=jnp.asarray(MU_FRICTION, dtype),
                    eps=jnp.asarray(1e-3, dtype),
                    active=active_t[k],
                    contact_id=k,
                )
            ),
            core.NegativeOrthant(),
        )
        for k in range(NK)
    )
    boundary = (
        # stages[0]: force rates pinned to zero
        (
            core.GatedFunction(
                func=core.ControlErrorResidual(target=jnp.zeros((NU,), dtype)),
                gate=g_first,
            ),
            core.EqualityConstraint(),
        ),
        # stages[0] and stages[-1]: zero linear acceleration + momentum
        (
            core.GatedFunction(
                func=CentroidalWrapperResidual(inner=lin_acc),
                gate=g_first + g_last,
            ),
            core.EqualityConstraint(),
        ),
        (
            core.GatedFunction(
                func=CentroidalWrapperResidual(inner=lin_mom),
                gate=g_first + g_last,
            ),
            core.EqualityConstraint(),
        ),
        # stages[-1]: zero angular momentum
        (
            core.GatedFunction(
                func=CentroidalWrapperResidual(
                    inner=AngularMomentumResidual(L_ref=zero3)
                ),
                gate=g_last,
            ),
            core.EqualityConstraint(),
        ),
    )
    return core.make_stage(cost, dyn, space, NU, cones + boundary)


def rest_forces(active_t, dtype):
    """Distribute the weight over the active contacts (reference warm start,
    ``continuous-centroidal.py:288-299``)."""
    n_act = jnp.sum(active_t)
    fz = -MASS * GRAVITY[2] / jnp.maximum(n_act, 1.0)
    f = jnp.zeros((NK, 3), dtype).at[:, 2].set(fz * active_t)
    return f.reshape(-1)


def create_problem(T_ds=10, T_ss=40, T_tail=50, dtype=jnp.float64):
    active, points, com_final = make_schedule(T_ds, T_ss, T_tail, dtype)
    T = active.shape[0]

    # fz regularization ×100 where a contact switches on/off between stages
    act_np = np.asarray(active)
    switched = np.zeros((T, NK), bool)
    switched[1:] = act_np[1:] != act_np[:-1]
    w_force = np.ones((T, NK, 3))
    w_force[switched, 2] = 100.0
    w_force = w_force.reshape(T, NU)

    g_first = jnp.zeros((T,), dtype).at[0].set(1.0)
    g_last = jnp.zeros((T,), dtype).at[T - 1].set(1.0)

    stages = core.stack_stages(
        [
            make_stage_at(
                active[t],
                points[t],
                jnp.asarray(w_force[t], dtype),
                g_first[t],
                g_last[t],
                dtype,
            )
            for t in range(T)
        ]
    )

    x0 = jnp.concatenate(
        [
            jnp.asarray(COM_INITIAL, dtype),
            jnp.zeros((6,), dtype),
            rest_forces(active[0], dtype),
        ]
    )
    term_cost = core.ConstantCost(c=jnp.asarray(0.0, dtype))
    term_constraints = (
        (
            CentroidalCoMResidual(c_ref=jnp.asarray(com_final, dtype)),
            core.EqualityConstraint(),
        ),
    )
    problem = core.make_problem(
        x0,
        make_stage_at(
            active[0],
            points[0],
            jnp.asarray(w_force[0], dtype),
            g_first[0],
            g_last[0],
            dtype,
        ),
        T,
        term_cost,
        term_constraints=term_constraints,
        stages=stages,
    )
    xs_init = jnp.stack(
        [
            jnp.concatenate([x0[:9], rest_forces(active[min(t, T - 1)], dtype)])
            for t in range(T + 1)
        ]
    )
    return problem, xs_init, com_final


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem, xs_init, com_final = create_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-5,
        mu_init=1e-8,
        max_iters=100,
        max_al_iters=20,
        rollout="linear",
        ls_strategy="filter",
        filter_beta=1e-5,
    )
    res = solvers.solve(problem, cfg, xs_init=xs_init)
    print("converged:", bool(res.conv), " iters:", int(res.num_iters))
    print("final CoM:", res.xs[-1, :3], "(target", com_final, ")")
    f = np.asarray(res.xs[:-1, 9:]).reshape(-1, NK, 3)
    print("fz range over active contacts: [%.2f, %.2f] N"
          % (f[:, :, 2].min(), f[:, :, 2].max()))
    rates = np.abs(np.asarray(res.us)).max()
    print("max |force rate|: %.2f N/s" % rates)
