"""Quadrotor goto with obstacle avoidance (counterpart of reference
``examples/quadrotor_obstacles.py``): free-flyer rigid body with four rotor
thrusts, cylindrical column keep-outs (``Column`` residual role,
``quadrotor_obstacles.py:51``), a floor half-space z >= 0
(``create_halfspace_z`` role, ``quadrotor_obstacles.py:37``), control
bounds, and an optional terminal equality on the goal position
(``term_cstr`` role) — all as negative-orthant / equality constraints."""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import pytree_dataclass
from aligator_tpu.modelling import IntegratorSemiImplEuler
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.robots import make_model
from aligator_tpu.modelling.dynamics.multibody_free import MultibodyFreeFwdDynamics
from aligator_tpu.core.functions import StageFunction


def make_quadrotor(mass=1.5, arm=0.2, kf=1.0, km=0.016):
    joints = [
        dict(
            type=rbd.FREEFLYER,
            parent=-1,
            mass=mass,
            com=jnp.zeros(3),
            inertia=jnp.diag(jnp.array([0.013, 0.013, 0.022])),
        )
    ]
    model = make_model(joints, frames=[dict(name="base", parent=0)])
    # actuation: rotor thrusts → body wrench (fz + roll/pitch/yaw torques)
    B = jnp.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [kf, kf, kf, kf],
            [0.0, arm * kf, 0.0, -arm * kf],
            [-arm * kf, 0.0, arm * kf, 0.0],
            [km, -km, km, -km],
        ]
    )
    return model, B


@pytree_dataclass
class CylinderKeepOut(StageFunction):
    """r(x) = radius² − ‖p_xy − c‖² ≤ 0 (stay OUTSIDE the cylinder)."""

    center: jax.Array  # (2,)
    radius: jax.Array

    def value(self, space, x, u):
        dxy = x[..., :2] - self.center
        return (self.radius**2 - jnp.sum(dxy * dxy, -1))[..., None]


def create_quadrotor_problem(nsteps=60, timestep=0.033, dtype=jnp.float64,
                             term_cstr=False):
    model, B = make_quadrotor()
    space = model.phase_space()
    nu = 4

    ode = MultibodyFreeFwdDynamics(model=model, actuation=B.astype(dtype))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x_tgt = space.neutral().at[0].set(1.5).at[1].set(1.5).at[2].set(1.0)
    u_hover = jnp.full((nu,), 1.5 * 9.81 / 4, dtype)

    w_x = jnp.diag(
        jnp.concatenate([jnp.full(3, 1.0), jnp.full(3, 0.1), jnp.full(6, 0.1)])
    ).astype(dtype)
    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_tgt, w_x * timestep),
        core.QuadraticControlCost(0.1 * jnp.eye(nu, dtype=dtype) * timestep, u_hover),
    )
    term_cost = core.QuadraticStateCost(x_tgt, 10.0 * w_x)

    # two columns between start and goal (reference places a cylinder grid
    # and prunes infeasible starts; same machinery, fixed layout here)
    obstacles = tuple(
        (
            CylinderKeepOut(center=jnp.asarray(c, dtype),
                            radius=jnp.asarray(0.3, dtype)),
            core.NegativeOrthant(),
        )
        for c in ([0.75, 0.75], [1.25, 0.25])
    )
    # floor half-space z >= 0: -z <= 0 as a linear state residual
    # (reference create_halfspace_z, quadrotor_obstacles.py:37-48)
    Az = jnp.zeros((1, space.ndx), dtype).at[0, 2].set(-1.0)
    floor = (
        core.LinearFunction(A=Az, B=jnp.zeros((1, nu), dtype),
                            c=jnp.zeros((1,), dtype)),
        core.NegativeOrthant(),
    )
    bounds = (
        core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
        core.BoxConstraint(
            lower=jnp.zeros((nu,), dtype), upper=jnp.full((nu,), 12.0, dtype)
        ),
    )

    stage = core.make_stage(rcost, dyn, space, nu, obstacles + (floor, bounds))
    x0 = space.neutral()
    term_constraints = ()
    if term_cstr:
        # terminal equality on the goal position (reference args.term_cstr:
        # StateErrorResidual on the target, quadrotor_obstacles.py:176-180)
        pos_err = core.FunctionSlice(
            func=core.StateErrorResidual(target=x_tgt), indices=(0, 1, 2)
        )
        term_constraints = ((pos_err, core.EqualityConstraint()),)
    return core.make_problem(x0, stage, nsteps, term_cost,
                             term_constraints=term_constraints)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    import sys

    term_cstr = "--term_cstr" in sys.argv
    problem = create_quadrotor_problem(term_cstr=term_cstr)
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-2, max_iters=200, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("pN:", res.xs[-1][:3], "(target: [1.5, 1.5, 1.0])")
    xy = res.xs[:, :2]
    for c in ((0.75, 0.75), (1.25, 0.25)):
        d = jnp.linalg.norm(xy - jnp.array(c), axis=-1)
        print(f"min dist to column {c}:", float(d.min()), "(radius 0.3)")
    print("min z:", float(res.xs[:, 2].min()), "(floor z >= 0)")
    print("u range:", float(res.us.min()), float(res.us.max()))
