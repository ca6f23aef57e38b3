"""Double-integrator LQR (counterpart of reference ``examples/lqr.py``).

Solves a linear-quadratic problem with ProxDDP; optionally with control
bounds. Run directly for a CPU smoke test.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import core, solvers


def make_lqr_problem(nsteps=100, dtype=jnp.float64, u_bound=None):
    dt_ = 0.1
    space = core.VectorSpace(2)
    nu = 1
    A = jnp.array([[1.0, dt_], [0.0, 1.0]], dtype)
    B = jnp.array([[0.0], [dt_]], dtype)
    c = jnp.zeros((2,), dtype)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=c)

    Q = 0.01 * jnp.eye(2, dtype=dtype)
    R = 0.01 * jnp.eye(1, dtype=dtype)
    cost = core.QuadraticCost.create(Q * dt_, R * dt_)
    term_cost = core.QuadraticCost.create(10.0 * jnp.eye(2, dtype=dtype), 0.0 * R)

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

    stage = core.make_stage(cost, dyn, space, nu, constraints)
    x0 = jnp.array([1.0, 0.0], dtype)
    return core.make_problem(x0, stage, nsteps, term_cost)


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem = make_lqr_problem(nsteps=20)
    cfg = solvers.ProxDDPConfig(tol=1e-8, mu_init=1e-2, max_iters=20)
    res = solvers.solve(problem, cfg)
    print("conv:", bool(res.conv), "iters:", int(res.num_iters),
          "al_iters:", int(res.al_iter))
    print("prim:", float(res.prim_infeas), "dual:", float(res.dual_infeas))
    print("cost:", float(res.traj_cost))
    print("x0:", res.xs[0], "xN:", res.xs[-1])
