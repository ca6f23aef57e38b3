"""Benchmark: batched SE(2)-car ProxDDP solves/s on one GPU.

Mirrors the reference benchmark protocol (``bench/se2-car.cpp:11-16``):
SE(2) car parking, N = 50 steps, ProxDDP with tol = 1e-3, μ₀ = 1e-3,
max_iters = 4, LINEAR rollout — but batched over thousands of scenarios
(randomized initial states).

Prints ONE JSON line:
  {"metric": "se2car_solves_per_sec", "value": N, "unit": "solves/s",
   "device": {...}, ...extras}

Extras in the same line:
  * ``se2car_scan_solves_per_sec`` — the same fleet with the fused LQ
    kernel bypassed (``linear_solver='serial_scan'``): the end-to-end
    comparison that decides whether the kernel stays.
  * ``humanoid_solves_per_sec`` — ProxDDP at humanoid dims (nx=36, nu=12,
    N=100, control bounds; the dims of the reference gar bench
    ``bench/gar-riccati.cpp:18``), batch 1024.
  * ``gar_fused_lq_solves_per_sec`` / ``gar_fused_speedup_vs_scan`` /
    ``gar_fused_min_traffic_gbps`` — the fused Triton Riccati kernel at
    (nx=4, nu=2, nc=2, N=50), batch 8192, vs the vmapped XLA scan;
    bandwidth is on a minimum-traffic basis (inputs read once + outputs
    written once).
  * ``lqr56_proxddp_solves_per_sec`` / ``lqr56_fddp_solves_per_sec`` —
    both solvers at the reference dense-LQR shape (``bench/lqr.cpp:23-57``,
    nx=56, nu=22, N=100, max_iters=2), batch 256.
  * ``lq_xla_ms_*`` / ``fd_rows_ms_quadruped_b16`` — XLA-path times of the
    medium-dim LQ solves and of the whole-body derivative rows, the phases
    that have no hand-written kernel.
  * ``lq_latency_*`` — single-problem LQ latency at N = 2048, serial vs
    associative.

Needs an NVIDIA GPU; exits non-zero on any other device.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from aligator_tpu import core, solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from aligator_tpu import gar  # noqa: E402
from aligator_tpu.gar import riccati  # noqa: E402
from aligator_tpu.modelling.multibody.quadruped import (  # noqa: E402
    make_quadruped,
    standing_configuration,
)
from examples.se2_car import create_se2_problem  # noqa: E402


def _tree_bytes(tree):
    return sum(
        int(np.prod(l.shape)) * l.dtype.itemsize for l in jax.tree.leaves(tree)
    )


def timed(fn, *args, n_rep=5):
    """``(seconds, output)`` of ``jax.jit(fn)(*args)``: the least of
    ``n_rep`` calls after a warm-up, each ending in ``block_until_ready``."""
    f = jax.jit(fn)
    out = jax.block_until_ready(f(*args))  # compile + warm
    ts = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), out


# --- programs shared with chip_smoke.py ----------------------------------
# chip_smoke.py compiles these same functions, so with the persistent
# compile cache one run of both compiles each program once.


def fleet_fn(problem, one):
    """``x0s -> results``: ``one(problem, x0)`` vmapped over a fleet."""

    def solve_fleet(x0s):
        return jax.vmap(lambda x0: one(problem, x0))(x0s)

    return solve_fleet


def lq_problems(batch, N, nx, nu, nc, explicit, dtype=jnp.float32, seed=0):
    """Random jointly convex proximal LQ problems (ProxDDP's domain);
    general-E problems get ``-I + O(0.05)`` dynamics blocks, the form of a
    manifold difference-chart Jacobian."""
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    probs = jax.vmap(
        lambda k: gar.random_convex_problem(k, N, nx, nu, nc, dtype=dtype)
    )(keys)
    if not explicit:
        dE = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), probs.knots.E.shape, dtype
        )
        probs = replace(probs, knots=replace(probs.knots, E=probs.knots.E + dE))
    return probs


def lq_fused_fn(mu, explicit, interpret=False):
    """Batched LQ solve through the fused Triton kernel."""
    from aligator_tpu.gar import pallas_riccati

    def lq_fused(probs):
        return pallas_riccati.solve(probs, mu, mu, assume_explicit=explicit,
                                    interpret=interpret)

    return lq_fused


def lq_scan_fn(mu, explicit):
    """Batched LQ solve on the vmapped XLA scan, pinned to ``highest``."""

    def lq_scan(probs):
        with jax.default_matmul_precision("highest"):
            return jax.vmap(
                lambda p: riccati.solve(p, mu, mu, explicit)
            )(probs)

    return lq_scan


# SE(2) fleet LQ: tangent dims nx=3, nu=2, no path constraints, manifold
# (general) E blocks, N=50
SE2_LQ_SHAPE = (50, 3, 2, 0, False)


def bench_gar_lq(batch=8192, shape=SE2_LQ_SHAPE, mu=1e-3):
    """Raw LQ-solve throughput at the SE(2) fleet's LQ shape: fused Triton
    kernel vs the XLA scan path, plus the fused kernel's achieved bandwidth
    on a minimum-traffic basis (inputs read once + outputs written once —
    a lower bound)."""
    explicit = shape[-1]
    probs = lq_problems(batch, *shape)
    fused = lq_fused_fn(mu, explicit)
    t_fused, _ = timed(fused, probs)
    t_scan, _ = timed(lq_scan_fn(mu, explicit), probs)
    nbytes = _tree_bytes(probs) + _tree_bytes(jax.eval_shape(fused, probs))
    return dict(
        fused_solves_per_sec=batch / t_fused,
        fused_speedup_vs_scan=t_scan / t_fused,
        fused_min_traffic_gbps=nbytes / t_fused / 1e9,
    )


def quadruped_states(model, batch, dtype=jnp.float32):
    """Stance-like quadruped states, as a walking or standing problem
    visits them."""
    cspace = model.configuration_space()
    q0 = standing_configuration(model).astype(dtype)
    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(2), (batch, model.nv), dtype)
    q = jax.vmap(lambda d: cspace.integrate(q0, d))(dq)
    v = 0.2 * jax.random.normal(jax.random.PRNGKey(3), (batch, model.nv), dtype)
    tau = 2.0 * jax.random.normal(
        jax.random.PRNGKey(4), (batch, model.nv), dtype
    )
    return q, v, tau


FD_KW = dict(kd=1e-2, contact_dims=(3, 3, 3, 3))


def fd_rows_fn(model, frames, dtype=jnp.float32):
    """Batched contact-dynamics derivatives (derivative-rows pass plus its
    KKT solves) of the quadruped's four point feet."""
    from aligator_tpu.modelling.multibody import derivatives as drv

    active = jnp.ones((len(frames),), dtype)

    def fd_rows(q, v, tau):
        return jax.vmap(
            lambda q_, v_, t_: drv.constrained_fd_derivatives(
                model, q_, v_, t_, frames, active, **FD_KW
            )[2:]
        )(q, v, tau)

    return fd_rows


def quadruped_feet():
    model = make_quadruped()
    return model, tuple(model.frame_id(f"foot{i}") for i in range(4))


def make_humanoid_dims_problem(nsteps=100, dtype=jnp.float32):
    """ProxDDP problem at humanoid dims (nx=36, nu=12): an 18-DoF
    double-integrator chain with a 6-DoF unactuated (floating-base-like)
    block and control bounds."""
    nq = 18
    nx, nu = 2 * nq, 12
    dt_ = 0.02
    I = jnp.eye(nq, dtype=dtype)
    A = jnp.block([[I, dt_ * I], [jnp.zeros((nq, nq), dtype), I]])
    Bv = jnp.concatenate([jnp.zeros((6, nu), dtype), jnp.eye(nu, dtype=dtype)])
    B = jnp.concatenate([jnp.zeros((nq, nu), dtype), dt_ * Bv])
    space = core.VectorSpace(nx)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=jnp.zeros((nx,), dtype))
    cost = core.QuadraticCost.create(
        0.01 * jnp.eye(nx, dtype=dtype), 0.001 * jnp.eye(nu, dtype=dtype)
    )
    term_cost = core.QuadraticCost.create(
        10.0 * jnp.eye(nx, dtype=dtype), jnp.zeros((nu, nu), dtype)
    )
    constraints = (
        (
            core.ControlErrorResidual(target=jnp.zeros((nu,), dtype)),
            core.BoxConstraint(
                lower=-2.0 * jnp.ones((nu,), dtype),
                upper=2.0 * jnp.ones((nu,), dtype),
            ),
        ),
    )
    stage = core.make_stage(cost, dyn, space, nu, constraints)
    x0 = jnp.zeros((nx,), dtype).at[0].set(0.5)
    return core.make_problem(x0, stage, nsteps, term_cost)


def humanoid_config():
    return solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
        rollout="linear", ls_max_steps=6,
    )


def humanoid_initial_states(batch, dtype=jnp.float32):
    x0 = make_humanoid_dims_problem(nsteps=100, dtype=dtype).x0
    return x0 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(3), (batch, x0.shape[0]), dtype
    )


def proxddp_one(cfg):
    """``(problem, x0) -> ProxDDPResults``: one scenario of a fleet."""

    def one(problem, x0):
        return solvers.solve(replace(problem, x0=x0), cfg)

    return one


def bench_humanoid(batch=1024):
    problem = make_humanoid_dims_problem(nsteps=100, dtype=jnp.float32)
    fleet = fleet_fn(problem, proxddp_one(humanoid_config()))
    t, _ = timed(fleet, humanoid_initial_states(batch), n_rep=3)
    return batch / t


def se2_problem(dtype=jnp.float32, nsteps=50):
    return create_se2_problem(nsteps=nsteps, dtype=dtype)


def se2_config(linear_solver="serial"):
    # ls_strategy='filter': same 4x4 budget, same protocol (the filter is a
    # reference step-acceptance strategy, core/filter.hpp:12). The fp64
    # NumPy oracle ablation (tests/test_convergence_ablation.py) showed
    # that the unconverged tail under the nonmonotone linesearch is
    # budget-bound for BACKTRACKING acceptance — the filter accepts the
    # full Newton steps those draws need at identical cost per iteration.
    return solvers.ProxDDPConfig(
        tol=1e-3,
        mu_init=1e-3,
        max_iters=4,
        max_al_iters=4,
        rollout="linear",
        ls_max_steps=6,
        ls_strategy="filter",
        linear_solver=linear_solver,
    )


def se2_initial_states(batch, dtype=jnp.float32):
    """Randomized parking scenarios around the nominal initial state."""
    d_p = 0.2 * jax.random.normal(jax.random.PRNGKey(0), (batch, 2), dtype)
    d_th = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (batch,), dtype)
    theta0 = 0.15355 + d_th
    return jnp.stack(
        [
            0.7 + d_p[:, 0],
            -0.1 + d_p[:, 1],
            jnp.cos(theta0),
            jnp.sin(theta0),
        ],
        axis=-1,
    )


def bench_se2(batch, linear_solver="serial"):
    """SE(2) fleet solves/s and converged fraction."""
    cfg = se2_config(linear_solver)
    fleet = fleet_fn(se2_problem(), proxddp_one(cfg))
    x0s = se2_initial_states(batch)
    # past 32768 scenarios the fleet is solved in chunks inside the jit
    # (lax.map reuses one chunk's buffers): a memory bound, whose size
    # chip_smoke.py prints with the card's memory_analysis
    chunk = min(batch, 32768)
    if batch > chunk:
        plain = fleet

        def fleet(x0s):
            out = jax.lax.map(plain, x0s.reshape(batch // chunk, chunk, -1))
            return jax.tree.map(
                lambda a: a.reshape((batch,) + a.shape[2:]), out
            )

    t, res = timed(fleet, x0s)
    finite = np.isfinite(np.asarray(res.us)).all(axis=(1, 2))
    conv = (finite & (np.asarray(res.prim_infeas) <= cfg.tol)
            & (np.asarray(res.dual_infeas) <= cfg.tol))
    return batch / t, float(conv.mean())


def bench_lq_xla(batch, nx, nu, nc, N=100):
    """Seconds per batched LQ solve on the vmapped XLA scan (the path that
    medium dims take; no hand-written kernel covers them)."""
    return timed(
        lq_scan_fn(1e-3, True), lq_problems(batch, N, nx, nu, nc, True)
    )[0]


def bench_fd_rows(batch=16):
    """Seconds per batched contact-dynamics derivative evaluation
    (quadruped, 4 point feet) on the XLA path."""
    model, frames = quadruped_feet()
    return timed(
        fd_rows_fn(model, frames), *quadruped_states(model, batch)
    )[0]


def main():
    from aligator_tpu.utils.device import (
        device_record, enable_compile_cache, gpu_name_and_power, require_gpu,
    )

    devices = require_gpu(jax.devices())
    enable_compile_cache(".")
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 32768

    solves_per_sec, frac_conv = bench_se2(batch)
    scan_solves_per_sec, scan_frac_conv = bench_se2(batch, "serial_scan")
    humanoid_sps = bench_humanoid()
    lq = bench_gar_lq()
    # ProxDDP-vs-FDDP at the reference bench/lqr.cpp shape
    from bench_lqr import run_both as lqr_run_both

    lqr_rates = lqr_run_both(batch=256)
    lq36 = bench_lq_xla(1024, 36, 12, 12)
    lq56 = bench_lq_xla(256, 56, 22, 0)
    fd_rows = bench_fd_rows()

    # single-scenario LQ latency, serial vs associative O(log N), one
    # long-horizon config (the full sweep lives in bench_latency.py)
    from bench_latency import assoc_solve, serial_solve

    lat_prob = gar.random_convex_problem(
        jax.random.PRNGKey(2052), 2048, 4, 2, 0, dtype=jnp.float32
    )
    lat_serial, _ = timed(serial_solve, lat_prob)
    lat_assoc, _ = timed(assoc_solve, lat_prob)

    out = {
        "metric": "se2car_solves_per_sec",
        "value": solves_per_sec,
        "unit": "solves/s",
        "batch": batch,
        "frac_converged": frac_conv,
        "se2car_scan_solves_per_sec": scan_solves_per_sec,
        "se2car_scan_frac_converged": scan_frac_conv,
        "humanoid_solves_per_sec": humanoid_sps,
        "gar_fused_lq_solves_per_sec": lq["fused_solves_per_sec"],
        "gar_fused_speedup_vs_scan": lq["fused_speedup_vs_scan"],
        "gar_fused_min_traffic_gbps": lq["fused_min_traffic_gbps"],
        "lqr56_proxddp_solves_per_sec": lqr_rates["proxddp"],
        "lqr56_fddp_solves_per_sec": lqr_rates["fddp"],
        "lq_xla_ms_nx36_b1024": lq36 * 1e3,
        "lq_xla_ms_nx56_b256": lq56 * 1e3,
        "fd_rows_ms_quadruped_b16": fd_rows * 1e3,
        "lq_latency_serial_N2048_ms": lat_serial * 1e3,
        "lq_latency_assoc_N2048_ms": lat_assoc * 1e3,
        "lq_latency_assoc_speedup": lat_serial / lat_assoc,
        "device": device_record(devices),
        "card": gpu_name_and_power(),
        "jax": jax.__version__,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
