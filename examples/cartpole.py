"""Cartpole swing-up with control bounds (counterpart of reference
``examples/cartpole.py``; one of the BASELINE.md parity configs).

State x = (p, θ, ṗ, θ̇) ∈ R⁴ (θ = 0 hanging down, θ = π upright),
control u = horizontal force on the cart. Classic analytic dynamics.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core
from aligator_tpu._pytree import pytree_dataclass
from aligator_tpu.modelling import IntegratorRK2, ODE


@pytree_dataclass
class CartpoleODE(ODE):
    mc: jax.Array  # cart mass
    mp: jax.Array  # pole mass
    length: jax.Array
    gravity: jax.Array

    def xdot(self, space, x, u):
        th, pdot, thdot = x[..., 1], x[..., 2], x[..., 3]
        f = u[..., 0]
        s, c = jnp.sin(th), jnp.cos(th)
        mt = self.mc + self.mp
        # standard cartpole equations (pole hanging at th=0)
        denom = mt - self.mp * c * c
        pddot = (
            f + self.mp * s * (self.length * thdot**2 + self.gravity * c)
        ) / denom
        thddot = (
            -f * c
            - self.mp * self.length * thdot**2 * c * s
            - mt * self.gravity * s
        ) / (self.length * denom)
        return jnp.stack([pdot, thdot, pddot, thddot], axis=-1)


def create_cartpole_problem(
    nsteps=100, timestep=0.02, u_bound=25.0, dtype=jnp.float64
):
    space = core.VectorSpace(4)
    nu = 1
    ode = CartpoleODE(
        mc=jnp.asarray(1.0, dtype),
        mp=jnp.asarray(0.1, dtype),
        length=jnp.asarray(0.5, dtype),
        gravity=jnp.asarray(9.81, dtype),
    )
    dyn = IntegratorRK2(ode=ode, timestep=jnp.asarray(timestep, dtype))

    x_target = jnp.array([0.0, jnp.pi, 0.0, 0.0], dtype)
    w_x = jnp.diag(jnp.array([0.1, 1.0, 0.01, 0.01], dtype)) * timestep
    w_u = 1e-3 * jnp.eye(nu, dtype=dtype) * timestep
    w_term = jnp.diag(jnp.array([10.0, 100.0, 1.0, 1.0], dtype))

    rcost = core.CostStack.create(
        core.QuadraticStateCost(x_target, w_x),
        core.QuadraticControlCost(w_u),
    )
    term_cost = core.QuadraticStateCost(x_target, w_term)

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
    x0 = jnp.zeros((4,), dtype)
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    from aligator_tpu import solvers

    problem = create_cartpole_problem(nsteps=100)
    cfg = solvers.ProxDDPConfig(
        tol=1e-5, mu_init=0.01, max_iters=300, rollout="nonlinear"
    )
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    xN = res.xs[-1]
    print("xN:", xN, "(target: [0, pi, 0, 0])")
    print("max |u|:", float(jnp.max(jnp.abs(res.us))))
