"""Smoke test of the batched solvers on one NVIDIA GPU.

Drives the main path — ``solvers.solve`` under ``jax.jit(jax.vmap(...))``,
the way ``bench.py`` does — at the benchmark's sizes, in one process, and
checks what comes out against plain references:

1. device check (a GPU, or exit non-zero with no result);
2. the fused Triton LQ kernel against the vmapped XLA scan pinned to
   ``highest`` and a float64 solve, with the Triton call asserted in the
   compiled HLO;
3. the SE(2)-car fleet, ProxDDP, batch 32768;
4. humanoid dims (nx=36) at batch 1024, and dense LQR-56 under ProxDDP and
   FDDP at batch 256;
5. whole-body contact-dynamics derivative rows (quadruped, batch 16)
   against float64 ``jacfwd``;
6. single-problem LQ latency path at N=2048: serial against associative.

``--four-cards`` runs only the multi-device paths (scenario-sharded fleet
and time-sharded Riccati legs on four cards), each beside its reference.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# --- tolerances, each with its reason ------------------------------------
# Kernel vs the "highest"-pinned XLA scan, both fp32: the two evaluate the
# same recursion in different operation orders, and the μ = 1e-3 Schur
# blocks (condition ~1/μ) amplify fp32 round-off over N = 50 stages.
TOL_KERNEL_VS_SCAN = 1e-3
# Either fp32 path vs the float64 solve of the same problems: the same
# round-off budget, measured against the exact answer.
TOL_FP32_VS_FP64 = 1e-3
# Solver controls, fp32 on the card vs float64 at the same iteration
# budget: each run stops once its KKT residual is below tol = 1e-3, so the
# two trajectories may differ by O(tol) relative to the largest control.
TOL_SOLVER_CONTROLS = 1e-2
# LQR-56 runs a fixed 2-iteration budget with tol 1e-7: after the first
# Newton step both precisions hold the LQR optimum up to fp32 round-off
# amplified by the 56-dim recursion.
TOL_LQR_CONTROLS = 1e-3
# Contact-dynamics derivatives, fp64 analytic vs fp64 jacfwd: equal up to
# fp64 round-off amplified by the prox-regularized contact KKT (prox
# μ = 1e-8) over 16 random states.
TOL_DERIV_FP64 = 1e-6
# The fp32 run (the solver's dtype) is printed, not held to a tolerance:
# four coplanar point feet make the Delassus matrix rank-deficient, the fp32
# regularization floor (64·eps·max diag G, far above the fp64 prox μ) is a
# softer contact model than fp64's, and the analytic derivatives treat that
# floor as constant where jacfwd differentiates it. Only finiteness is
# checked there.
# Serial vs associative O(log N) LQ at N = 2048, fp32, μ = 1e-3 (inside
# the associative solver's fp32 domain, one refinement step).
TOL_LATENCY_PATHS = 1e-2
# Multi-card results vs one card / the serial sweep: sharded scenario
# batches run the same per-scenario program, but XLA may pick other matmul
# kernels for the per-card batch than for the whole one, and the rounding
# differences pass through the solver's iterations (the bound of
# TOL_SOLVER_CONTROLS); parallel legs reassociate the recursion through a
# condensed interface system (fp32, N = 2047).
TOL_FOUR_CARD_BATCH = 1e-2
TOL_FOUR_CARD_LEGS = 1e-2

FLEET_BATCH = 32768
LQ_BATCH = 8192
F64_SAMPLE = 64


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_diff(a, b):
    """max |a - b| / max |b| (0 for empty arrays)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def has_triton_call(hlo_text: str) -> bool:
    """Whether compiled HLO text holds a Pallas Triton custom call (XLA's
    own Triton fusions use another form, so they do not count)."""
    return 'custom_call_target="__gpu$xla.gpu.triton"' in hlo_text


def memory_record(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k) for k in keys if hasattr(m, k)}


def compile_timed(fn, *args):
    import jax

    lowered = jax.jit(fn).lower(*args)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    return compiled, time.perf_counter() - t0


def nonfinite_fraction(us):
    import numpy as np

    us = np.asarray(us)
    return float((~np.isfinite(us.reshape(us.shape[0], -1)).all(1)).mean())


# ---------------------------------------------------------------- phase 2


def phase_lq_kernel(shapes, batch=LQ_BATCH, f64_sample=F64_SAMPLE,
                    mu=1e-3, interpret=False):
    """Fused kernel vs the highest-pinned vmapped scan and a float64 solve.
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests),
    where no Triton call is compiled."""
    import jax
    import jax.numpy as jnp

    import bench
    from aligator_tpu import gar
    from aligator_tpu.gar import riccati

    results = []
    for (N, nx, nu, nc, explicit) in shapes:
        probs = bench.lq_problems(batch, N, nx, nu, nc, explicit)
        compiled, t_compile = compile_timed(
            bench.lq_fused_fn(mu, explicit, interpret), probs
        )
        triton = has_triton_call(compiled.as_text())
        got = compiled(probs)
        ref = jax.jit(bench.lq_scan_fn(mu, explicit))(probs)

        def kkt(p, sol):
            errs = jax.vmap(
                lambda q, xs, us, vs, lams: jnp.stack(
                    gar.kkt_error(q, xs, us, vs, lams, mu, mu)
                )
            )(p, *sol)
            return [float(e) for e in jnp.max(errs, axis=0)]

        with jax.enable_x64(True):
            p64 = jax.tree.map(
                lambda a: jnp.asarray(a[:f64_sample], jnp.float64), probs
            )
            ref64 = jax.jit(jax.vmap(
                lambda q: riccati.solve(q, mu, mu, explicit)
            ))(p64)
            ref64 = [jax.device_get(a) for a in ref64]

        names = ("xs", "us", "vs", "lams")
        vs_scan = {n: rel_diff(g, r) for n, g, r in zip(names, got, ref)}
        vs_f64 = {
            n: rel_diff(g[:f64_sample], r) for n, g, r in zip(names, got, ref64)
        }
        scan_vs_f64 = {
            n: rel_diff(s[:f64_sample], r) for n, s, r in zip(names, ref, ref64)
        }
        rec = dict(
            shape=dict(N=N, nx=nx, nu=nu, nc=nc, explicit=explicit,
                       batch=batch),
            compile_s=t_compile, triton_in_hlo=triton,
            kernel_vs_scan=vs_scan, kernel_vs_f64=vs_f64,
            scan_vs_f64=scan_vs_f64,
            kkt_kernel=kkt(probs, got), kkt_scan=kkt(probs, ref),
            tol_kernel_vs_scan=TOL_KERNEL_VS_SCAN,
            tol_fp32_vs_fp64=TOL_FP32_VS_FP64,
        )
        say("lq_kernel", **rec)
        if not interpret:
            check(triton, "Triton custom call missing from the compiled HLO")
        for n in ("xs", "us", "lams"):
            check(vs_scan[n] <= TOL_KERNEL_VS_SCAN, f"kernel vs scan {n}")
            check(vs_f64[n] <= TOL_FP32_VS_FP64, f"kernel vs fp64 {n}")
            check(scan_vs_f64[n] <= TOL_FP32_VS_FP64, f"scan vs fp64 {n}")
        results.append(rec)
    return results


# ---------------------------------------------------------------- phases 3-4


def to_float64(tree):
    """Cast the floating-point leaves of a pytree to float64 (call inside
    ``jax.enable_x64``): the same problem data, not a fresh random draw."""
    import jax
    import jax.numpy as jnp

    def cast(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(a, jnp.float64)
        return a

    return jax.tree.map(cast, tree)


def solver_phase(name, make_problem, solve_one, x0s, tol_controls,
                 conv_of, f64_sample=F64_SAMPLE, expect_triton=None):
    """Run ``vmap(solve_one)`` over ``x0s`` (fp32 on the default device),
    then ``f64_sample`` of the same scenarios in float64 at the same
    budget."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench

    problem = make_problem(dtype=jnp.float32)
    compiled, t_compile = compile_timed(bench.fleet_fn(problem, solve_one), x0s)
    triton = has_triton_call(compiled.as_text())
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(x0s))
    t_run = time.perf_counter() - t0
    us = np.asarray(res.us)
    nonfinite = nonfinite_fraction(us)
    frac_conv = float(np.mean(conv_of(res)))

    with jax.enable_x64(True):
        p64 = to_float64(problem)
        x64 = jnp.asarray(np.asarray(x0s[:f64_sample]), jnp.float64)
        res64 = jax.jit(bench.fleet_fn(p64, solve_one))(x64)
        us64 = np.asarray(res64.us)
        conv64 = float(np.mean(conv_of(res64)))
    d_us = rel_diff(us[:f64_sample], us64)
    rec = dict(
        batch=int(x0s.shape[0]), compile_s=t_compile, run_s=t_run,
        nonfinite_frac=nonfinite, frac_converged=frac_conv,
        frac_converged_f64_sample=conv64, controls_vs_f64=d_us,
        tol_controls=tol_controls, triton_in_hlo=triton,
        memory=memory_record(compiled),
    )
    say(name, **rec)
    check(nonfinite == 0.0, f"{name}: non-finite solves")
    check(d_us <= tol_controls, f"{name}: controls vs float64")
    if expect_triton is not None:
        check(triton == expect_triton,
              f"{name}: Triton kernel expected={expect_triton}")
    return rec


def bench_conv(tol):
    import numpy as np

    def conv_of(res):
        us = np.asarray(res.us)
        finite = np.isfinite(us.reshape(us.shape[0], -1)).all(1)
        return (finite & (np.asarray(res.prim_infeas) <= tol)
                & (np.asarray(res.dual_infeas) <= tol))

    return conv_of


def solver_conv(res):
    """The solver's own convergence flags (tolerance met at exit)."""
    import numpy as np

    return np.asarray(res.conv)


def phase_se2_fleet(batch=FLEET_BATCH, f64_sample=F64_SAMPLE,
                    expect_triton=True):
    import bench

    cfg = bench.se2_config()
    x0s = bench.se2_initial_states(batch)
    return solver_phase(
        "se2_fleet", bench.se2_problem, bench.proxddp_one(cfg), x0s,
        TOL_SOLVER_CONTROLS, bench_conv(cfg.tol), f64_sample, expect_triton,
    )


def phase_medium(humanoid_batch=1024, lqr_batch=256, f64_sample=F64_SAMPLE):
    import bench
    import bench_lqr

    cfg = bench.humanoid_config()
    out = [solver_phase(
        "humanoid_dims", bench.make_humanoid_dims_problem,
        bench.proxddp_one(cfg), bench.humanoid_initial_states(humanoid_batch),
        TOL_SOLVER_CONTROLS, bench_conv(cfg.tol), f64_sample,
    )]
    x0s = bench_lqr.initial_states(lqr_batch)
    for solver, one in bench_lqr.solvers_one().items():
        out.append(solver_phase(
            f"lqr56_{solver}", bench_lqr.make_dense_lqr, one, x0s,
            TOL_LQR_CONTROLS, solver_conv, f64_sample,
        ))
    return out


# ---------------------------------------------------------------- phase 5


def phase_derivative_rows(batch=16):
    """Contact-dynamics derivatives (quadruped, 4 point feet) through the
    derivative-rows pass against ``jacfwd`` of the raw forward dynamics in
    float64; the float32 run is printed beside float32 ``jacfwd``."""
    import jax
    import jax.numpy as jnp

    import bench
    from aligator_tpu.modelling.multibody import contact as ct

    names = ("da_dq", "da_dv", "da_dtau", "df_dq", "df_dv", "df_dtau")

    def compare(dtype):
        model, frames = bench.quadruped_feet()
        active = jnp.ones((len(frames),), dtype)
        cspace = model.configuration_space()
        q, v, tau = bench.quadruped_states(model, batch, dtype)

        def raw(q_, v_, t_):
            out = ct._cfd_internals(model, q_, v_, t_, frames, active,
                                    **bench.FD_KW)
            return out["a"], -out["lam"]

        def jac(q_, v_, t_):
            z = jnp.zeros((model.nv,), dtype)
            Jq = jax.jacfwd(lambda d: raw(cspace.integrate(q_, d), v_, t_))(z)
            Jv = jax.jacfwd(lambda d: raw(q_, v_ + d, t_))(z)
            Jt = jax.jacfwd(lambda d: raw(q_, v_, t_ + d))(z)
            return Jq[0], Jv[0], Jt[0], Jq[1], Jv[1], Jt[1]

        compiled, t_compile = compile_timed(
            bench.fd_rows_fn(model, frames, dtype), q, v, tau
        )
        got = jax.device_get(compiled(q, v, tau))
        ref = jax.device_get(jax.jit(jax.vmap(jac))(q, v, tau))
        errs = {
            n: float(abs(g - r).max()) / max(1.0, float(abs(r).max()))
            for n, g, r in zip(names, got, ref)
        }
        finite = all(bool(np.isfinite(g).all()) for g in got)
        return errs, finite, t_compile

    import numpy as np

    with jax.enable_x64(True):
        err64, finite64, t64 = compare(jnp.float64)
    err32, finite32, t32 = compare(jnp.float32)
    rec = dict(batch=batch, compile_s_fp64=t64, compile_s_fp32=t32,
               fp64_vs_jacfwd=err64, fp32_vs_jacfwd_fp32=err32,
               fp32_finite=finite32, tol_fp64=TOL_DERIV_FP64)
    say("derivative_rows", **rec)
    check(finite64 and finite32, "non-finite derivatives")
    for n in names:
        check(err64[n] <= TOL_DERIV_FP64, f"fp64 derivative {n}")
    return rec


# ---------------------------------------------------------------- phase 6


def phase_latency(N=2048):
    import jax
    import jax.numpy as jnp

    import bench_latency
    from aligator_tpu import gar

    prob = gar.random_convex_problem(
        jax.random.PRNGKey(2052), N, 4, 2, 0, dtype=jnp.float32
    )
    rec = {"N": N}
    outs = {}
    for name, fn in (("serial", bench_latency.serial_solve),
                     ("associative", bench_latency.assoc_solve)):
        compiled, t_compile = compile_timed(fn, prob)
        t0 = time.perf_counter()
        outs[name] = jax.block_until_ready(compiled(prob))
        rec[f"{name}_compile_s"] = t_compile
        rec[f"{name}_first_call_s"] = time.perf_counter() - t0
    names = ("xs", "us", "lams")
    sel = (0, 1, 3)
    rec["assoc_vs_serial"] = {
        n: rel_diff(outs["associative"][i], outs["serial"][i])
        for n, i in zip(names, sel)
    }
    rec["tol"] = TOL_LATENCY_PATHS
    say("lq_latency", **rec)
    for n in names:
        check(rec["assoc_vs_serial"][n] <= TOL_LATENCY_PATHS,
              f"associative vs serial {n}")
    return rec


# ---------------------------------------------------------------- four cards


def shard_record(arr) -> list:
    return [
        {"device": str(s.device), "bytes": int(s.data.nbytes)}
        for s in arr.addressable_shards
    ]


def phase_four_card_fleet(devices, batch=FLEET_BATCH, nsteps=50):
    """``parallel.batched_solve`` of the SE(2) fleet over a ("batch",) mesh
    of ``devices`` vs the same inputs on ``devices[0]`` alone."""
    import jax
    import numpy as np

    import bench
    from aligator_tpu.parallel import mesh as mesh_mod

    cfg = bench.se2_config()
    problem = bench.se2_problem(nsteps=nsteps)
    one = bench.proxddp_one(cfg)
    x0s = bench.se2_initial_states(batch)
    mesh = mesh_mod.make_mesh(devices, axis_names=("batch",))
    t0 = time.perf_counter()
    res = jax.block_until_ready(
        mesh_mod.batched_solve(lambda x0: one(problem, x0).us, x0s, mesh=mesh)
    )
    t_mesh = time.perf_counter() - t0
    ref = jax.jit(jax.vmap(lambda x0: one(problem, x0).us))(
        jax.device_put(x0s, devices[0])
    )
    shards = shard_record(res)
    d = rel_diff(np.asarray(res), np.asarray(ref))
    rec = dict(batch=batch, n_devices=len(devices), mesh_first_call_s=t_mesh,
               vs_one_device=d, tol=TOL_FOUR_CARD_BATCH,
               sharding=str(res.sharding), shards=shards,
               nonfinite_frac=nonfinite_fraction(res))
    say("four_card_fleet", **rec)
    check(d <= TOL_FOUR_CARD_BATCH, "sharded fleet vs one device")
    check(len({s["device"] for s in shards}) == len(devices),
          "fleet output not spread over every device")
    return rec


def phase_four_card_legs(devices, N=2047, nx=4, nu=2):
    """``gar.parallel.solve_sharded`` with one leg per device on a
    ("time",) mesh vs the serial ``riccati.solve``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aligator_tpu import gar
    from aligator_tpu.gar import parallel as gar_parallel
    from aligator_tpu.gar import riccati

    mesh = Mesh(list(devices), axis_names=("time",))
    prob = gar.random_convex_problem(
        jax.random.PRNGKey(7), N, nx, nu, 0, dtype=jnp.float32
    )
    out = jax.block_until_ready(gar_parallel.solve_sharded(
        prob, 1e-3, 1e-3, mesh=mesh, axis_name="time", assume_explicit=True,
    ))
    ref = jax.jit(lambda p: riccati.solve(p, 1e-3, 1e-3, True))(prob)
    names = ("xs", "us", "lams")
    sel = (0, 1, 3)
    diffs = {n: rel_diff(out[i], ref[i]) for n, i in zip(names, sel)}
    rec = dict(N=N, nx=nx, nu=nu, legs=len(devices), vs_serial=diffs,
               tol=TOL_FOUR_CARD_LEGS,
               sharding=str(out[0].sharding), shards=shard_record(out[0]))
    say("four_card_legs", **rec)
    for n in names:
        check(diffs[n] <= TOL_FOUR_CARD_LEGS, f"time-sharded legs {n}")
    return rec


# ---------------------------------------------------------------- main


def last_line(devices) -> str:
    from aligator_tpu.utils.device import device_record

    return json.dumps({"ok": True, "device": device_record(devices)})


def run_phases(phases):
    """Run the phases on threads of this one process, so that their XLA and
    Triton compilations overlap on the host's cores; re-raise the first
    failure once all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(phases)) as pool:
        futures = [pool.submit(p) for p in phases]
    for f in futures:
        f.result()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    sys.path.insert(0, ROOT)

    import jax

    from aligator_tpu.utils.device import (
        enable_compile_cache, gpu_name_and_power, require_gpu,
    )

    devices = require_gpu(jax.devices())
    cache = enable_compile_cache(ROOT)
    card = gpu_name_and_power()
    say("device", devices=[str(d) for d in devices], nvidia_smi=card,
        compile_cache=cache, jax=jax.__version__)
    t0 = time.perf_counter()
    if four:
        check(len(devices) >= 4,
              f"--four-cards needs 4 GPUs, found {len(devices)}")
        run_phases([
            lambda: phase_four_card_fleet(devices[:4]),
            lambda: phase_four_card_legs(devices[:4]),
        ])
    else:
        run_phases([
            lambda: phase_lq_kernel([(50, 3, 2, 0, False)]),
            lambda: phase_lq_kernel([(50, 4, 2, 2, True)]),
            phase_se2_fleet,
            phase_medium,
            phase_derivative_rows,
            phase_latency,
        ])
    say("done", wall_s=time.perf_counter() - t0)
    print(card, flush=True)
    print(last_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
