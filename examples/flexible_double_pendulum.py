"""Flexible double pendulum swing-up (underactuated, spring-coupled).

Counterpart of the reference ``examples/flexible_double_pendulum.py``: each
flexible link is approximated by two rigid segments connected by a passive
torsional spring-damper (a 2-segment Craig–Bampton-style reduction), giving
a 4-DoF chain where only the two *physical* joints (segment 1 of each link)
are actuated. The reference builds the model symbolically with sympy; here
the same mechanics come from the rigid-body layer +
:class:`MultibodyFlexibleFwdDynamics` (τ = B u − K(q−q₀) − D v).

Task: swing the flexible chain from hanging to upright under torque bounds
— the solver must exploit (not fight) the oscillations of the passive
segments.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu.modelling import IntegratorRK2
from aligator_tpu.modelling.dynamics.multibody_free import (
    MultibodyFlexibleFwdDynamics,
)
from aligator_tpu.modelling.multibody.model import REVOLUTE, make_model


def make_flexible_double_pendulum(
    l1=0.5, l2=0.5, m1=0.8, m2=0.6,
):
    """4-revolute planar chain: [shoulder, flex1, elbow, flex2] about +y;
    each physical link split into two half-length segments with the link
    mass split 50/50; hangs along −z at q = 0."""
    eps = 1e-6
    y = jnp.array([0.0, 1.0, 0.0])
    h1, h2 = l1 / 2, l2 / 2
    joints = [
        dict(type=REVOLUTE, parent=-1, axis=y, mass=m1 / 2,
             com=jnp.array([0.0, 0.0, -h1]), inertia=eps * jnp.eye(3)),
        dict(type=REVOLUTE, parent=0, axis=y, mass=m1 / 2,
             placement_p=jnp.array([0.0, 0.0, -h1]),
             com=jnp.array([0.0, 0.0, -h1]), inertia=eps * jnp.eye(3)),
        dict(type=REVOLUTE, parent=1, axis=y, mass=m2 / 2,
             placement_p=jnp.array([0.0, 0.0, -h1]),
             com=jnp.array([0.0, 0.0, -h2]), inertia=eps * jnp.eye(3)),
        dict(type=REVOLUTE, parent=2, axis=y, mass=m2 / 2,
             placement_p=jnp.array([0.0, 0.0, -h2]),
             com=jnp.array([0.0, 0.0, -h2]), inertia=eps * jnp.eye(3)),
    ]
    frames = [dict(name="tip", parent=3, placement_p=jnp.array([0.0, 0.0, -h2]))]
    return make_model(joints, frames)


def create_flexible_pendulum_problem(
    nsteps=120,
    timestep=0.025,
    u_bound=12.0,
    k_flex=60.0,
    d_flex=0.08,
    dtype=jnp.float64,
):
    model = make_flexible_double_pendulum()
    nv = model.nv  # 4
    space = model.phase_space()
    nu = 2  # shoulder + elbow; flex joints are passive

    B = jnp.zeros((nv, nu), dtype).at[0, 0].set(1.0).at[2, 1].set(1.0)
    stiffness = jnp.array([0.0, k_flex, 0.0, k_flex], dtype)
    damping = jnp.array([0.12, d_flex, 0.1, d_flex], dtype)
    ode = MultibodyFlexibleFwdDynamics(
        model=model, actuation=B, stiffness=stiffness, damping=damping,
        q_rest=jnp.zeros((model.nq,), dtype),
    )
    dyn = IntegratorRK2(ode=ode, timestep=jnp.asarray(timestep, dtype))

    # upright: physical joints at π (flex joints at rest)
    x_target = jnp.zeros((2 * nv,), dtype).at[0].set(jnp.pi)
    w_x = jnp.diag(
        jnp.array([1.0, 0.5, 1.0, 0.5, 0.05, 0.05, 0.05, 0.05], dtype)
    ) * timestep
    w_u = 1e-3 * jnp.eye(nu, dtype=dtype) * timestep
    w_term = jnp.diag(
        jnp.array([100.0, 50.0, 100.0, 50.0, 10.0, 10.0, 10.0, 10.0], dtype)
    )

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_target, w_x),
        core.QuadraticControlCost(w_u),
    )
    term_cost = core.QuadraticStateCost(x_target, w_term)

    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=-u_bound * jnp.ones((nu,), dtype),
                upper=u_bound * jnp.ones((nu,), dtype),
            ),
        ),
    )
    stage = core.make_stage(rcost, dyn, space, nu, constraints)
    x0 = jnp.zeros((2 * nv,), dtype)
    return core.make_problem(x0, stage, nsteps, term_cost), model


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem, model = create_flexible_pendulum_problem()
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=200, rollout="nonlinear",
        ls_strategy="armijo",
    )
    res = solvers.solve(problem, cfg)
    xN = res.xs[-1]
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("final q:", xN[:4], "(target q0 = pi, flex ~ 0)")
    print("max |tau|:", float(jnp.max(jnp.abs(res.us))))
    print(
        "max flex deflection along swing:",
        float(jnp.max(jnp.abs(res.xs[:, jnp.array([1, 3])]))),
    )
