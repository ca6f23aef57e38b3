"""Medium-dim (nx=36) Riccati ablation bench.

The humanoid-dim LQ path (nx=36, nu=12, N=100 — the reference gar bench
shape, ``bench/gar-riccati.cpp:18``) runs on the XLA scan. This harness
measures three ablations of it:

  (a) k-stage scan-body unrolling (``lax.scan(..., unroll=k)``) — amortizes
      per-step launch overhead across k stage kernels;
  (b) bf16 value-propagation GEMMs (A'V, B'V, A'VA, B'VB, A'VB in bf16
      inputs, fp32 accumulation) with the KKT core kept fp32
      (``_precision.py`` policy) — halves the bytes of the widest
      per-stage operands;
  (c) parallel-in-time leg condensation on one device (``gar/parallel.py``,
      L legs): the stage recursion shortens N → N/L while the vmapped leg
      axis widens every batched op L×, trading sequential depth for
      arithmetic width.

Every variant carries a KKT-residual accuracy audit (fp32). Problems are
JOINTLY convex (``gar.random_convex_problem``) — the class ProxDDP emits
and the leg split's operating domain (see gar/parallel.py docstring).

Timing: chained in-dispatch repetitions with a data-dependent perturbation
per rep; one host readback per timed dispatch.

Usage: ``python bench_medium.py [batch]`` — prints one JSON line.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.gar import lqr_problem as gar  # noqa: E402
from aligator_tpu.gar import parallel as gar_parallel  # noqa: E402
from aligator_tpu.gar import riccati  # noqa: E402

def chained(solver, probs, batch, nx, m, reps=3):
    """min over reps of (one dispatch of m chained solves) / m, seconds."""

    @jax.jit
    def run(probs):
        def body(i, acc):
            p = replace(
                probs,
                knots=replace(
                    probs.knots,
                    q=probs.knots.q + i * 1e-6 + acc[:, None, :] * 1e-20,
                ),
            )
            xs, us, vs, lams = solver(p)
            extra = us.sum() + vs.sum() + lams.sum()
            return acc + xs.mean(axis=1) + extra * jnp.float32(1e-20)

        return jax.lax.fori_loop(
            0, m, body, jnp.zeros((batch, nx), jnp.float32)
        ).sum()

    float(run(probs))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(probs))
        ts.append(time.perf_counter() - t0)
    return min(ts) / m


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    N, nx, nu, nc = 100, 36, 12, 12
    dtype = jnp.float32
    mu = 1e-3

    keys = jax.random.split(jax.random.PRNGKey(11), batch)
    probs = jax.vmap(
        lambda k: gar.random_convex_problem(k, N, nx, nu, nc, dtype=dtype)
    )(keys)

    def solver(unroll, bf16):
        def f(p):
            return jax.vmap(
                lambda pp: riccati.forward(
                    riccati.backward(
                        pp, mu, mu, True, unroll=unroll, bf16_prop=bf16
                    ),
                    unroll=unroll,
                )
            )(p)

        return f

    def leg_solver(legs):
        def f(p):
            return jax.vmap(
                lambda pp: gar_parallel.solve(
                    pp, mu, mu, legs=legs, assume_explicit=True
                )
            )(p)

        return f

    # accuracy audit: max KKT residual across a probe subset, per variant
    nprobe = min(batch, 64)
    probe = jax.tree.map(lambda a: a[:nprobe], probs)

    @jax.jit
    def kkt_err(p, xs, us, vs, lams):
        return jax.vmap(
            lambda pp, x, u, v, l: jnp.stack(
                gar.kkt_error(pp, x, u, v, l, mu, mu)
            )
        )(p, xs, us, vs, lams)

    variants = {
        "u1": solver(1, False),
        "u4": solver(4, False),
        "u1_bf16": solver(1, True),
        "legs4": leg_solver(4),
        "legs8": leg_solver(8),
        "legs16": leg_solver(16),
    }
    times, errs = {}, {}
    for name, sv in variants.items():
        times[name] = chained(sv, probs, batch, nx, m=3)
        xs, us, vs, lams = jax.jit(sv)(probe)
        errs[name] = float(jnp.max(kkt_err(probe, xs, us, vs, lams)))

    best = min(times, key=times.get)
    out = {
        "metric": "medium_dim_lq_solves_per_sec",
        "value": round(batch / times[best], 1),
        "unit": "solves/s",
        "speedup_vs_u1": round(times["u1"] / times[best], 3),
        "batch": batch,
        "dims": f"nx={nx},nu={nu},nc={nc},N={N}",
        "best": best,
        "ms_per_batch": {k: round(v * 1e3, 2) for k, v in times.items()},
        "kkt_err": {k: float(f"{v:.3e}") for k, v in errs.items()},
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
