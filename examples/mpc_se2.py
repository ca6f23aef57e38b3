"""Receding-horizon MPC on the SE(2) car — the production deployment
pattern: one jitted mpc_step doing (apply control → shift warm start →
re-solve), batched over scenarios.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import solvers, utils
from aligator_tpu._pytree import replace
from examples.se2_car import create_se2_problem

if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)

    problem = create_se2_problem(nsteps=30, dtype=jnp.float64)
    cfg = solvers.ProxDDPConfig(
        tol=1e-4, mu_init=1e-3, max_iters=10, max_al_iters=10
    )
    space = problem.space
    stage0 = problem.stage_at(0)

    res = solvers.solve(problem, cfg)
    xs_w, us_w = res.xs, res.us
    x_cur = problem.x0

    @jax.jit
    def mpc_step(x_cur, xs_w, us_w):
        u0 = us_w[0]
        x_next = stage0.dynamics.forward(space, x_cur, u0)
        xs_w2, us_w2 = utils.cycle_warm_start(xs_w, us_w)
        r = solvers.solve(
            replace(problem, x0=x_next), cfg, xs_init=xs_w2, us_init=us_w2
        )
        return x_next, r

    for k in range(25):
        x_cur, res = mpc_step(x_cur, xs_w, us_w)
        xs_w, us_w = res.xs, res.us
        if k % 5 == 0:
            d = float(jnp.linalg.norm(x_cur[:2]))
            print(f"cycle {k:2d}: |pos| = {d:.4f}  iters = {int(res.num_iters)}")

    print("final state:", x_cur)
