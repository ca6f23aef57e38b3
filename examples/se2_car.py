"""SE(2) car parking — the north-star benchmark problem.

Faithful re-creation of the reference problem definition
(``examples/se2-car.hpp:63-103`` and ``bench/se2-car.cpp``): unicycle-type
car on SE(2), state x = (px, py, cosθ, sinθ), control u = (v, ω), explicit
Euler integration with dt = 0.05, quadratic tracking costs to the origin.

The car ODE (``se2-car.hpp:33-61``):  ẋ = (v·cosθ, v·sinθ, ω), integrated as
a body twist on SE(2) — reproducing the reference's exact discrete dynamics.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import pytree_dataclass
from aligator_tpu.modelling import SE2, ODE, IntegratorEuler


@pytree_dataclass
class CarDynamics(ODE):
    """Unicycle kinematics (reference ``examples/se2-car.hpp:33``)."""

    def xdot(self, space, x, u):
        c, s = x[..., 2], x[..., 3]
        v, w = u[..., 0], u[..., 1]
        return jnp.stack([v * c, v * s, w], axis=-1)


def create_se2_problem(nsteps: int = 50, dtype=jnp.float32, u_bound=None):
    """Problem construction mirroring ``create_se2_problem``
    (examples/se2-car.hpp:63)."""
    space = SE2()
    nu = 2
    ndx = space.ndx
    timestep = 0.05

    theta0 = 0.15355
    x0 = jnp.array(
        [0.7, -0.1, jnp.cos(theta0), jnp.sin(theta0)], dtype=dtype
    )
    x_target = space.neutral().astype(dtype)

    w_x = 0.01 * jnp.eye(ndx, dtype=dtype)
    w_term = 10.0 * w_x
    w_u = jnp.eye(nu, dtype=dtype)

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_target, w_x * timestep),
        core.QuadraticControlCost(w_u * timestep),
    )
    term_cost = core.QuadraticStateCost(x_target, w_term)

    dyn = IntegratorEuler(ode=CarDynamics(), timestep=jnp.asarray(timestep, dtype))

    constraints = ()
    if u_bound is not None:
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
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem = create_se2_problem(nsteps=50, dtype=jnp.float64)
    cfg = solvers.ProxDDPConfig(tol=1e-6, mu_init=1e-2, max_iters=30)
    res = solvers.solve(problem, cfg)
    print(
        "conv:", bool(res.conv), "iters:", int(res.num_iters),
        "al:", int(res.al_iter),
    )
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print("cost:", float(res.traj_cost))
    print("x0:", res.xs[0])
    print("xN:", res.xs[-1], "(target: origin)")
