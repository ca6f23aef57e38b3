"""gar Riccati benchmark (counterpart of reference ``bench/gar-riccati.cpp``):
random LQ problems at humanoid-ish dims (nx=36, nu=12), horizon swept,
serial scan vs parallel-in-time legs, batched. Prints one JSON line per
configuration.

Usage: python bench_gar.py [batch]
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from aligator_tpu import gar  # noqa: E402
from aligator_tpu.gar import parallel  # noqa: E402


def timeit(fn, probs, reps=3):
    """Perturb the input per repetition and block on a host readback per
    repetition."""
    from aligator_tpu._pytree import replace

    def pert(i):
        return replace(
            probs, knots=replace(probs.knots, q=probs.knots.q + i * 1e-6)
        )

    float(jnp.asarray(fn(probs)).sum())  # compile + warm
    ts = []
    for i in range(1, reps + 1):
        t0 = time.perf_counter()
        float(jnp.asarray(fn(pert(jnp.asarray(i, probs.knots.q.dtype)))).sum())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    nx, nu, nc = 36, 12, 0
    dtype = jnp.float32

    for N in (32, 64, 128):
        keys = jax.random.split(jax.random.PRNGKey(0), batch)
        probs = jax.vmap(
            lambda k: gar.random_problem(k, N - 1, nx, nu, nc, dtype=dtype)
        )(keys)

        f_serial = jax.jit(
            jax.vmap(lambda p: gar.solve(p, 1e-3, 1e-3, assume_explicit=True)[0])
        )
        t_serial = timeit(f_serial, probs)

        legs = 8
        f_par = jax.jit(
            jax.vmap(
                lambda p: parallel.solve(
                    p, 1e-3, 1e-3, legs=legs, assume_explicit=True
                )[0]
            )
        )
        t_par = timeit(f_par, probs)

        for name, t in (("serial", t_serial), (f"parallel{legs}", t_par)):
            print(
                json.dumps(
                    {
                        "metric": f"gar_riccati_{name}_N{N}",
                        "value": round(batch / t, 1),
                        "unit": "solves/s",
                        "horizon": N,
                        "nx": nx,
                        "nu": nu,
                        "batch": batch,
                    }
                )
            )


if __name__ == "__main__":
    main()
