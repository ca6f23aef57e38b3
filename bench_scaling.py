"""Scaling-efficiency harness: batched SE(2)-car solves over an N-device mesh.

On a host with several cards this measures scaling efficiency (1 card → N
cards). On the CPU, pass --virtual to fake N host devices and validate the
sharded execution path; virtual-device timings measure correctness of the
harness, not hardware scaling.

Prints one JSON line per device count.
"""

import json
import sys
import time

if "--virtual" in sys.argv:
    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, ".")

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu.parallel import batched_solve, make_mesh  # noqa: E402
from examples.se2_car import create_se2_problem  # noqa: E402


def main():
    per_device = 512
    problem = create_se2_problem(nsteps=50, dtype=jnp.float32)
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
        rollout="linear", ls_max_steps=6,
    )

    def solve_one(x0):
        return solvers.solve(replace(problem, x0=x0), cfg).us

    n_avail = len(jax.devices())
    counts = sorted({1, 2, n_avail} & set(range(1, n_avail + 1)))
    base_rate = None
    for nd in counts:
        mesh = make_mesh(jax.devices()[:nd])
        B = per_device * nd
        key = jax.random.PRNGKey(0)
        x0s = jnp.stack(
            [
                0.7 + 0.2 * jax.random.normal(key, (B,), jnp.float32),
                -0.1 + jnp.zeros((B,), jnp.float32),
                jnp.full((B,), jnp.cos(0.15355), jnp.float32),
                jnp.full((B,), jnp.sin(0.15355), jnp.float32),
            ],
            axis=-1,
        )
        out = batched_solve(solve_one, x0s, mesh=mesh)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = batched_solve(solve_one, x0s, mesh=mesh)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        rate = B / dt
        if base_rate is None:
            base_rate = rate
        print(
            json.dumps(
                {
                    "metric": f"se2car_scaling_{nd}dev",
                    "value": round(rate, 1),
                    "unit": "solves/s",
                    "devices": nd,
                    "efficiency": round(rate / (base_rate * nd), 3),
                }
            )
        )


if __name__ == "__main__" and "--time" not in sys.argv and "--audit" not in sys.argv:
    main()


def main_time():
    """Time-axis (parallel-in-time) scaling: ONE long-horizon LQ solve with
    the leg axis sharded over the mesh (the reference's OpenMP-legs analog,
    parallel-solver.hxx:124). Strong scaling: horizon and leg count fixed
    (legs = 8), only the device count varies.

    NOTE: meaningful only on real multi-chip hardware. Under --virtual the
    "devices" share this host's physical cores, so speedup_vs_1dev ≈ 1 by
    construction — the run then validates the sharded execution path, not
    hardware scaling (same caveat as the batch-axis mode above)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from aligator_tpu import gar
    from aligator_tpu.gar import parallel as gar_parallel
    from aligator_tpu.gar import riccati

    def timed(fn, prob, reps=3):
        # host readback per repetition, which waits for the device
        float(fn(prob)[0].sum())
        ts = []
        for i in range(1, reps + 1):
            p = replace(
                prob, knots=replace(prob.knots, q=prob.knots.q + i * 1e-6)
            )
            t0 = time.perf_counter()
            float(fn(p)[0].sum())
            ts.append(time.perf_counter() - t0)
        return min(ts)

    devices = jax.devices()
    # two shapes: the small-dim long-horizon latency case, and the
    # medium-dim (nx=36 — humanoid/reference gar-riccati.cpp:18) case where
    # the condensed-system collectives actually carry nx*nx blocks
    # (VERDICT r2 item 9)
    for tag, N, nx, nu in (("", 1023, 8, 4), ("meddim_", 511, 36, 12)):
        # jointly convex stage costs: the leg-split kernel's operating
        # domain (gar.random_convex_problem docstring)
        prob = gar.random_convex_problem(
            jax.random.PRNGKey(0), N, nx, nu, 0, dtype=jnp.float32
        )
        t_serial = timed(
            jax.jit(lambda p: riccati.solve(p, 1e-3, 1e-3, True)), prob
        )
        print(json.dumps({
            "metric": f"pit_scaling_{tag}serial",
            "value": round(t_serial * 1e3, 2),
            "unit": "ms/solve", "devices": 1,
        }))

        base = None
        # dedupe device counts: on 1- or 2-device meshes (1, 2, len) overlaps
        # and would emit duplicate JSON rows (round-3 ADVICE)
        for n in sorted({1, 2, len(devices)}):
            if n > len(devices):
                continue
            mesh = Mesh(np.array(devices[:n]), axis_names=("time",))
            tsh = NamedSharding(mesh, P("time"))
            fn = jax.jit(
                lambda p, tsh=tsh: gar_parallel.solve(
                    p, 1e-3, 1e-3, legs=8, assume_explicit=True,
                    time_sharding=tsh,
                )
            )
            t = timed(fn, prob)
            if base is None:
                base = t
            print(json.dumps({
                "metric": f"pit_scaling_{tag}{n}dev",
                "value": round(t * 1e3, 2), "unit": "ms/solve",
                "devices": n,
                "speedup_vs_1dev": round(base / t, 3),
            }))


if __name__ == "__main__" and "--time" in sys.argv:
    import numpy as np  # noqa: F401

    main_time()
    sys.exit(0)


def main_audit():
    """Interface communication-volume audit for the parallel-in-time path:
    exact per-solve bytes crossing the leg interfaces (the only
    globally-coupled data in ``gar/parallel.py``) against per-leg sweep
    FLOPs, both counted from shapes.

    Per non-last leg the condensed system gathers P, Vxt, Vtt (nx² each),
    p, vt (nx each) and the interface E block (nx²); the condensed solution
    scatters x_head, λ_head, θ (nx each) back — see
    ``gar/parallel.py:165-210``.  Per-leg compute is (T/L)·stage_flops with
    the medium-dim stage decomposition (Schur solve / value GEMMs /
    reduced KKT). Turning these counts into times needs the link rate and
    the achieved FLOP rate of the card, which are measured, not assumed.
    """
    T, nx, nu, nc = 101, 36, 12, 12
    itemsize = 4
    # per-stage FLOPs (fp32, fused counts)
    chol = nx**3 / 3 + 2 * nx**2 * (nx + 1)          # Schur solve, 37 RHS
    gemms = 2 * nx**3 * 3 + 4 * nx**2 * nu            # A'V, A'VA, B'V, ...
    red = nu**3 / 3 + 2 * nu**2 * (1 + nx + nc) + 2 * nu * nc * (1 + nx)
    stage_flops = chol + gemms + red

    for legs in (2, 4, 8, 16, 32, 64):
        gather = legs * (3 * nx * nx + 2 * nx) * itemsize
        gather += (legs - 1) * nx * nx * itemsize  # interface E blocks
        scatter = legs * 3 * nx * itemsize
        comm_bytes = gather + scatter
        per_leg_flops = (T / legs) * stage_flops
        print(json.dumps({
            "metric": "pit_interface_comm_audit",
            "legs": legs,
            "interface_bytes": int(comm_bytes),
            "per_leg_stages": round(T / legs, 1),
            "per_leg_flops": int(per_leg_flops),
            "per_leg_flops_per_interface_byte": round(
                per_leg_flops / comm_bytes, 2
            ),
        }))


if __name__ == "__main__" and "--audit" in sys.argv:
    main_audit()
