"""Solo quadruped kinodynamics gait (counterpart of reference
``examples/solo_kinodynamics.py``).

Kinodynamic model: centroidal state (c, h, L) coupled with the Solo-class
quadruped's 8 joint coordinates driven by commanded accelerations,
u = (contact forces, joint accelerations) — reference
``modelling/dynamics/kinodynamics-fwd.hpp:32``. The walk schedule (two
diagonal swing phases) enters as stage-varying ``ContactMap`` leaves and
activity-gated friction cones; swing-leg motion is shaped by joint-space
tracking costs (the reference uses world-frame foot targets via Pinocchio
FK; the joint-space variant avoids carrying base pose in the reduced state).
"""

import jax
import jax.numpy as jnp
import numpy as np

from aligator_tpu import core, solvers
from aligator_tpu.modelling.centroidal import (
    CentroidalCoMResidual,
    CentroidalFrictionConeResidual,
    LinearMomentumResidual,
)
from aligator_tpu.modelling.dynamics.centroidal import (
    ContactMap,
    KinodynamicsFwdDynamics,
)
from aligator_tpu.modelling.dynamics.ode import IntegratorEuler

NK = 4  # LF, RF, LB, RB
NJ = 8  # hip + knee per leg
NU = 3 * NK + NJ
NX = 9 + 2 * NJ
MASS = 2.24  # Solo-8 class total mass
GRAVITY = np.array([0.0, 0.0, -9.81])
MU_FRICTION = 0.8
DT = 0.02


def make_schedule(dtype=jnp.float64):
    p0 = np.array(
        [[0.2, 0.15, 0.0], [0.2, -0.15, 0.0], [-0.2, 0.15, 0.0], [-0.2, -0.15, 0.0]]
    )
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.08  # LF, RB step
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.08  # RF, LB step
    T_ds, T_ss = 8, 20
    phases = [
        (T_ds, [1, 1, 1, 1], p0),
        (T_ss, [0, 1, 1, 0], p0),
        (T_ds, [1, 1, 1, 1], p1),
        (T_ss, [1, 0, 0, 1], p1),
        (T_ds, [1, 1, 1, 1], p2),
    ]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases])
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    # joint-space swing targets: flex the swinging legs' knees mid-phase
    q_nom = np.tile([0.8, -1.6], NK)  # hip, knee per leg
    q_ref = np.tile(q_nom, (active.shape[0], 1))
    swing = active == 0  # (T, nk)
    for k in range(NK):
        q_ref[swing[:, k], 2 * k] += 0.3  # extra hip flexion in swing
        q_ref[swing[:, k], 2 * k + 1] -= 0.4  # extra knee bend in swing
    return (
        jnp.asarray(active, dtype),
        jnp.asarray(points, dtype),
        jnp.asarray(q_ref, dtype),
        jnp.asarray(q_nom, dtype),
    )


def make_stage_at(active_t, points_t, q_ref_t, dtype=jnp.float64):
    space = core.VectorSpace(NX)
    cmap = ContactMap(points=points_t, active=active_t)
    ode = KinodynamicsFwdDynamics(
        contact_map=cmap,
        mass=jnp.asarray(MASS, dtype),
        gravity=jnp.asarray(GRAVITY, dtype),
        n_joints=NJ,
    )
    dyn = IntegratorEuler(ode=ode, timestep=jnp.asarray(DT, dtype))

    # state regularization: momenta + joint velocities; joint tracking to the
    # (stage-varying) swing reference; small control regularization
    w_x = np.zeros(NX)
    w_x[3:9] = 1e-1  # h, L
    w_x[9 + NJ :] = 1e-2  # v_j
    x_ref = jnp.concatenate(
        [jnp.zeros((9,), dtype), q_ref_t, jnp.zeros((NJ,), dtype)]
    )
    wq = np.zeros(NX)
    wq[9 : 9 + NJ] = 10.0
    cost = core.CostStack.create(
        core.QuadraticStateCost(x_ref, jnp.asarray(np.diag(w_x + wq), dtype)),
        core.QuadraticControlCost(1e-4 * jnp.eye(NU, dtype=dtype)),
        core.QuadraticResidualCost(
            residual=LinearMomentumResidual(h_ref=jnp.zeros((3,), dtype)),
            weights=1e-1 * jnp.eye(3, dtype=dtype),
        ),
    )

    constraints = tuple(
        (
            CentroidalFrictionConeResidual(
                mu=jnp.asarray(MU_FRICTION, dtype),
                eps=jnp.asarray(0.0, dtype),
                active=active_t[k],
                contact_id=k,
            ),
            core.NegativeOrthant(),
        )
        for k in range(NK)
    )
    return core.make_stage(cost, dyn, space, NU, constraints)


def create_kinodynamics_problem(dtype=jnp.float64):
    active, points, q_ref, q_nom = make_schedule(dtype)
    T = active.shape[0]
    stages = core.stack_stages(
        [make_stage_at(active[t], points[t], q_ref[t], dtype) for t in range(T)]
    )

    com0 = jnp.asarray([0.0, 0.0, 0.22], dtype)
    com_final = com0 + jnp.asarray([0.16, 0.0, 0.0], dtype)
    x0 = jnp.concatenate(
        [com0, jnp.zeros((6,), dtype), q_nom, jnp.zeros((NJ,), dtype)]
    )

    term_cost = core.QuadraticStateCost(
        jnp.concatenate(
            [com_final, jnp.zeros((6,), dtype), q_nom, jnp.zeros((NJ,), dtype)]
        ),
        jnp.asarray(
            np.diag(np.r_[np.zeros(3), np.ones(6), 10 * np.ones(NJ), np.ones(NJ)]),
            dtype,
        ),
    )
    term_constraints = (
        (CentroidalCoMResidual(c_ref=com_final), core.EqualityConstraint()),
    )
    return core.make_problem(
        x0,
        make_stage_at(active[0], points[0], q_ref[0], dtype),
        T,
        term_cost,
        term_constraints=term_constraints,
        stages=stages,
    )


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem = create_kinodynamics_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-5,
        mu_init=1e-7,
        max_iters=200,
        max_al_iters=20,
        rollout="linear",
        ls_strategy="filter",
    )
    res = solvers.solve(problem, cfg)
    print("converged:", bool(res.conv), " iters:", int(res.num_iters))
    print("final CoM:", res.xs[-1, :3])
    print("final joints:", np.round(np.asarray(res.xs[-1, 9 : 9 + NJ]), 3))
