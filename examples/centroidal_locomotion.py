"""Centroidal locomotion (counterpart of reference ``examples/centroidal.py``).

A quadruped-style gait on the 9-D centroidal state x = (c, h, L): four
contact points, a double-support / single-support contact schedule, friction
cone constraints on every active contact, and a terminal CoM placement
constraint. The reference builds type-heterogeneous stages (cone constraints
attached only where a contact is active); here stages are a single stacked
pytree and the schedule lives in stage-varying leaves (``ContactMap.active``
plus the cone residuals' ``active`` gates) — the accelerator-native idiom.
"""

import jax
import jax.numpy as jnp
import numpy as np

from aligator_tpu import core, solvers
from aligator_tpu.modelling.centroidal import (
    AngularAccelerationResidual,
    CentroidalAccelerationResidual,
    CentroidalCoMResidual,
    CentroidalFrictionConeResidual,
    LinearMomentumResidual,
)
from aligator_tpu.modelling.dynamics.centroidal import (
    CentroidalFwdDynamics,
    ContactMap,
)
from aligator_tpu.modelling.dynamics.ode import IntegratorEuler

MASS = 10.5
GRAVITY = np.array([0.0, 0.0, -9.81])
MU_FRICTION = 0.8
NK = 4  # LF, RF, LB, RB
NU = 3 * NK
DT = 0.01


def make_schedule(dtype=jnp.float64):
    """(T, nk) activity flags + (T, nk, 3) contact points: double support →
    swing {LF, RB} → double support (shifted) → swing {RF, LB} → double
    support (mirrors reference ``examples/centroidal.py:44-125`` cp1..cp5)."""
    p0 = np.array(
        [[0.2, 0.1, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.0]]
    )
    p1 = p0.copy()
    p1[[0, 3], 0] += 0.05  # LF, RB step forward
    p2 = p1.copy()
    p2[[1, 2], 0] += 0.05  # RF, LB step forward

    T_ds, T_ss = 10, 30
    phases = [
        (T_ds, [1, 1, 1, 1], p0),
        (T_ss, [0, 1, 1, 0], p0),
        (T_ds, [1, 1, 1, 1], p1),
        (T_ss, [1, 0, 0, 1], p1),
        (T_ds, [1, 1, 1, 1], p2),
    ]
    active = np.concatenate([np.tile(a, (n, 1)) for n, a, _ in phases])
    points = np.concatenate([np.tile(p, (n, 1, 1)) for n, _, p in phases])
    return jnp.asarray(active, dtype), jnp.asarray(points, dtype)


def make_stage_at(active_t, points_t, dtype=jnp.float64):
    space = core.VectorSpace(9)
    cmap = ContactMap(points=points_t, active=active_t)
    ode = CentroidalFwdDynamics(
        contact_map=cmap,
        mass=jnp.asarray(MASS, dtype),
        gravity=jnp.asarray(GRAVITY, dtype),
    )
    dyn = IntegratorEuler(ode=ode, timestep=jnp.asarray(DT, dtype))

    eye3 = jnp.eye(3, dtype=dtype)
    cost = core.CostStack.create(
        core.QuadraticCost.create(
            jnp.zeros((9, 9), dtype), 1e-1 * jnp.eye(NU, dtype=dtype)
        ),
        core.QuadraticResidualCost(
            residual=LinearMomentumResidual(h_ref=jnp.zeros((3,), dtype)),
            weights=10.0 * eye3,
        ),
        core.QuadraticResidualCost(
            residual=AngularAccelerationResidual(
                contact_map=cmap, ref=jnp.zeros((3,), dtype)
            ),
            weights=0.1 * eye3,
        ),
        core.QuadraticResidualCost(
            residual=CentroidalAccelerationResidual(
                contact_map=cmap,
                mass=jnp.asarray(MASS, dtype),
                gravity=jnp.asarray(GRAVITY, dtype),
                a_ref=jnp.zeros((3,), dtype),
            ),
            weights=100.0 * eye3,
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


def create_centroidal_problem(dtype=jnp.float64):
    active, points = make_schedule(dtype)
    T = active.shape[0]
    stages = core.stack_stages(
        [make_stage_at(active[t], points[t], dtype) for t in range(T)]
    )

    com_initial = jnp.asarray([0.1, 0.05, 0.15], dtype)
    com_final = jnp.asarray([0.2, 0.05, 0.15], dtype)
    x0 = jnp.concatenate([com_initial, jnp.zeros((6,), dtype)])

    term_cost = core.ConstantCost(c=jnp.asarray(0.0, dtype))
    term_constraints = (
        (
            CentroidalCoMResidual(c_ref=com_final),
            core.EqualityConstraint(),
        ),
    )
    return core.make_problem(
        x0,
        make_stage_at(active[0], points[0], dtype),
        T,
        term_cost,
        term_constraints=term_constraints,
        stages=stages,
    )


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem = create_centroidal_problem()
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
    print("final CoM:", res.xs[-1, :3], "(target [0.2, 0.05, 0.15])")
    fz = np.asarray(res.us).reshape(-1, 4, 3)[:, :, 2]
    print("max |fz|: %.2f N  min fz (active stages): %.3f N"
          % (fz.max(), fz.min()))
