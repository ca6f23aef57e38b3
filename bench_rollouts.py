"""Rollout-type comparison bench — linear vs nonlinear ProxDDP rollouts.

Counterpart of the reference ``examples/rollouts_bench.py``: solve the
UR5 end-effector reach with both rollout strategies across a ``mu_init``
sweep and report iterations-to-convergence, infeasibilities, final cost,
and wall time per config.  The reference sweeps
``RolloutType(0|1) x mu_init in {1e-1..1e-5}`` on the same task
(rollouts_bench.py:22-86); here ``rollout='linear'`` is the accelerator-friendly
default (parallel-solver compatible) and ``rollout='nonlinear'`` is the
closed-loop feedback rollout (``_nonlinear_rollout``,
solver-proxddp.hxx:339 analog).

Run: ``python bench_rollouts.py`` (one jitted dispatch per config, one
JSON line per config + a summary line).
"""

import itertools
import json
import time

import jax
import jax.numpy as jnp

from aligator_tpu import solvers
from examples.ur5_reach import create_ur5_problem


def main():
    # unbounded torque variant, fp32 on device (the reference bench runs
    # the free reach: no constraints beyond dynamics)
    problem, _, _ = create_ur5_problem(
        nsteps=40, timestep=0.025, tau_bound=None, dtype=jnp.float32
    )

    mu_vals = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)
    rows = []
    for rollout, mu0 in itertools.product(("linear", "nonlinear"), mu_vals):
        cfg = solvers.ProxDDPConfig(
            tol=1e-4,
            mu_init=mu0,
            max_iters=12,
            max_al_iters=8,
            rollout=rollout,
        )
        run = jax.jit(lambda p, cfg=cfg: solvers.solve(p, cfg))
        res = run(problem)  # compile + first solve
        # perturb inputs every repetition and block on a host readback
        # each time
        dt = float("inf")
        for i in range(1, 4):
            p_i = jax.tree.map(
                lambda a: a + jnp.float32(i * 1e-7)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                else a,
                problem,
            )
            t0 = time.perf_counter()
            float(run(p_i).traj_cost)  # host readback blocks the dispatch
            dt = min(dt, time.perf_counter() - t0)
        row = {
            "rollout": rollout,
            "mu_init": mu0,
            "converged": bool(res.conv),
            "num_iters": int(res.num_iters),
            "prim": float(res.prim_infeas),
            "dual": float(res.dual_infeas),
            "cost": float(res.traj_cost),
            "solve_ms": round(dt * 1e3, 2),
        }
        rows.append(row)
        print(json.dumps(row))

    n_conv = sum(r["converged"] for r in rows)
    print(
        json.dumps(
            {
                "metric": "rollouts_bench_converged_configs",
                "value": n_conv,
                "unit": f"of {len(rows)} (rollout x mu_init grid)",
            }
        )
    )


if __name__ == "__main__":
    main()
