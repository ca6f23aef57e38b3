"""Single-scenario LQ solve LATENCY: serial scan vs associative (O(log N))
vs parallel legs, on the device.

The parallel-in-time solvers (``gar/parallel.py``, ``gar/associative.py``
— the RSS-2024 parallel-Riccati claim the reference implements in
``gar/parallel-solver.hpp:24``) are correctness-proven by the tests; this
bench measures their latency: ONE problem (batch 1), horizon
N ∈ {128, 512, 2048}, small dims (nx=4, the MPC regime) and SE2-car dims
(nx=3, nu=2).

Timing: per-solve latency is measured with the chained-scan delta method —
K solves run inside one compiled ``lax.scan``, each iteration's problem
perturbed by the PREVIOUS iteration's solution (a true data dependency, so
the device cannot overlap them), and the reported latency is
``(t(K_hi) − t(K_lo)) / (K_hi − K_lo)``, which cancels all fixed dispatch
overhead.  fp32, μ = 1e-3 (inside the associative solver's fp32
domain).

Prints one JSON line per configuration + a summary line.
Usage: python bench_latency.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, ".")

from aligator_tpu import gar  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.gar import associative, parallel, riccati  # noqa: E402

MU = 1e-3
DTYPE = jnp.float32


def serial_solve(prob):
    f = riccati.backward(prob, MU, MU, True)
    return riccati.forward(f)


def assoc_solve(prob):
    return associative.solve(prob, MU, MU, refine_steps=1)


def legs_solve(prob, L):
    return parallel.solve(prob, MU, MU, L, assume_explicit=True)


def chained_latency(solve_fn, prob, k_lo=1, k_hi=5, reps=3):
    """Per-solve latency via the chained-scan delta method."""
    q0 = prob.knots.q

    def runner(K):
        @jax.jit
        def run(q):
            def body(qc, _):
                pr = replace(prob, knots=replace(prob.knots, q=qc))
                xs, us, vs, lams = solve_fn(pr)
                # data dependency: next problem's q is perturbed by this
                # solve's mean control (serializes the chain on-chip)
                qn = q0 * (1.0 + 1e-7 * jnp.tanh(jnp.mean(us)))
                return qn, us[0, 0]
            qf, outs = lax.scan(body, q, None, length=K)
            return outs.sum() + qf.sum()

        return run

    run_lo, run_hi = runner(k_lo), runner(k_hi)
    float(run_lo(q0))  # compile
    float(run_hi(q0))
    t_lo = t_hi = float("inf")
    for i in range(1, reps + 1):
        qp = q0 + jnp.asarray(i * 1e-7, DTYPE)
        t0 = time.perf_counter()
        float(run_lo(qp))
        t_lo = min(t_lo, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(run_hi(qp))
        t_hi = min(t_hi, time.perf_counter() - t0)
    return (t_hi - t_lo) / (k_hi - k_lo)


def main():
    rows = []
    for nx, nu, tag in ((4, 2, "nx4"), (3, 2, "se2dim")):
        for N in (128, 512, 2048):
            prob = gar.random_convex_problem(
                jax.random.PRNGKey(N + nx), N, nx, nu, 0, dtype=DTYPE
            )
            legs = 8 if N >= 512 else 4
            lat = {
                "serial": chained_latency(serial_solve, prob),
                "assoc": chained_latency(assoc_solve, prob),
                f"legs{legs}": chained_latency(
                    lambda p, L=legs: legs_solve(p, L), prob
                ),
            }
            best = min(lat, key=lat.get)
            row = {
                "metric": f"lq_latency_{tag}_N{N}",
                "unit": "ms/solve",
                **{f"{k}_ms": round(v * 1e3, 3) for k, v in lat.items()},
                "best": best,
                "assoc_speedup_vs_serial": round(
                    lat["serial"] / lat["assoc"], 3
                ),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    assoc_wins = sum(r["assoc_speedup_vs_serial"] > 1.0 for r in rows)
    print(
        json.dumps(
            {
                "metric": "lq_latency_summary",
                "value": assoc_wins,
                "unit": f"configs (of {len(rows)}) where associative beats "
                "serial single-scenario latency",
            }
        )
    )


if __name__ == "__main__":
    main()
