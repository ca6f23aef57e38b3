"""Talos-walk whole-body OCP solve-time benchmark (reference
``bench/talos-walk.cpp`` analog, batched).

Fixed-budget timing per the se2-car protocol (max_iters=4, tol=1e-3,
μ₀=1e-3): this measures solver throughput on the whole-body multi-contact
problem (nv=28 humanoid, 6D flat-foot contacts, semi-implicit Euler,
control bounds), not convergence — the walk needs ~30+ iterations to
converge (see examples/talos_walk.py).

Prints ONE JSON line. Kept separate from bench.py because the whole-body
stack takes minutes to compile.

``--profile``: per-phase device timings of one solver
iteration's components, each jitted separately and timed with the chained
perturbation + host-readback discipline — problem evaluation (a linesearch
trial: contact-KKT forward dynamics + costs), derivative evaluation (RBD +
contact-KKT Jacobians via autodiff), multiplier/LQ assembly, and the LQ
Riccati solve (ndx=56) — to identify the saturating component of the
whole-body solve (reference per-zone Tracy profile of
``bench/talos-walk.cpp``).
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from aligator_tpu import solvers  # noqa: E402
from aligator_tpu._pytree import replace  # noqa: E402
from examples.talos_walk import create_talos_walk_problem  # noqa: E402


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    problem, model, sched = create_talos_walk_problem(
        t_ds=4, t_ss=10, dtype=jnp.float32
    )
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
        rollout="linear", ls_max_steps=6, force_initial_condition=True,
    )
    x0 = problem.x0
    d = 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (batch, model.nv), jnp.float32
    )

    @jax.jit
    def solve_batch(dv):
        def one(dvi):
            x0i = x0.at[model.nq:].add(dvi)
            res = solvers.solve(replace(problem, x0=x0i), cfg)
            return res.us, res.prim_infeas

        return jax.vmap(one)(dv)

    def scalar(dv):
        us, prim = solve_batch(dv)
        return us.sum() + prim.sum()

    g = jax.jit(scalar)
    float(g(d))  # compile + warm
    ts = []
    for i in range(1, 4):  # perturbed reps + host readback (bench.py note)
        t0 = time.perf_counter()
        float(g(d + jnp.float32(i * 1e-6)))
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    print(
        json.dumps(
            {
                "metric": "talos_walk_solves_per_sec",
                "value": round(batch / dt, 2),
                "unit": "solves/s",
                "batch": batch,
                "nsteps": int(sched.shape[0]),
                "nv": int(model.nv),
            }
        )
    )


def profile(batch=16):
    """Per-phase device timings of the whole-body solve's components."""
    import types

    from aligator_tpu.core import problem as problem_mod
    from aligator_tpu.gar import riccati
    from aligator_tpu.solvers import proxddp as P

    problem, model, sched = create_talos_walk_problem(
        t_ds=4, t_ss=10, dtype=jnp.float32
    )
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
        rollout="linear", ls_max_steps=6, force_initial_condition=True,
    )
    N = problem.nsteps
    ndx, nu = problem.space.ndx, problem.nu
    nc, nct = problem.nc, problem.nc_term
    dtype = jnp.float32
    x0 = problem.x0
    d0 = 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (batch, model.nv), dtype
    )

    def iterates(dvi):
        x0i = x0.at[model.nq:].add(dvi)
        xs = jnp.broadcast_to(x0i, (N + 1,) + x0i.shape)
        us = jnp.zeros((N, nu), dtype)
        return x0i, xs, us

    mu = jnp.asarray(cfg.mu_init, dtype)
    st_like = types.SimpleNamespace(
        mu=mu,
        prev_lams=jnp.zeros((N + 1, ndx), dtype),
        prev_vs=jnp.zeros((N, nc), dtype),
        prev_vs_term=jnp.zeros((nct,), dtype),
    )

    def phase_eval(dvi):
        x0i, xs, us = iterates(dvi)
        data = problem_mod.evaluate(
            replace(problem, x0=x0i), xs, us
        )
        return data.cost + data.cstr_vals.sum() + data.dyn_res.sum()

    def phase_derivs(dvi):
        x0i, xs, us = iterates(dvi)
        data = problem_mod.compute_derivatives(
            replace(problem, x0=x0i), xs, us
        )
        return data.Lx.sum() + data.A.sum() + data.cstr_Jx.sum()

    def make_lq(dvi):
        x0i, xs, us = iterates(dvi)
        prob_i = replace(problem, x0=x0i)
        data = problem_mod.compute_derivatives(prob_i, xs, us)
        m = P._compute_multipliers(
            prob_i, cfg, data, st_like,
            st_like.prev_lams, st_like.prev_vs, st_like.prev_vs_term,
        )
        Lxs, Lus = P._lagrangian_grads(
            prob_i, cfg, data, st_like.prev_lams, st_like.prev_vs,
            st_like.prev_vs_term,
        )
        return prob_i, data, m, Lxs, Lus

    def assemble(dvi):
        prob_i, data, m, Lxs, Lus = make_lq(dvi)
        return P._assemble_lq(
            prob_i, cfg, data, m, Lxs, Lus, jnp.asarray(1e-9, dtype), mu
        )

    def phase_assemble(dvi):
        lq = assemble(dvi)
        return lq.knots.Q.sum() + lq.knots.q.sum() + lq.knots.C.sum()

    # LQ problems assembled once outside the timed region
    lqs = jax.jit(jax.vmap(assemble))(d0)
    jax.block_until_ready(lqs)

    def phase_lq(lq):
        f = riccati.backward(lq, cfg.dyn_al_scale * mu, mu, True)
        xs_, us_, vs_, lams_ = riccati.forward(f)
        return xs_.sum() + us_.sum() + vs_.sum() + lams_.sum()

    def phase_full(dvi):
        res = solvers.solve(
            replace(problem, x0=x0.at[model.nq:].add(dvi)), cfg
        )
        return res.us.sum() + res.prim_infeas

    def timed(fn, arg, perturb):
        g = jax.jit(lambda a: jax.vmap(fn)(a).sum())
        float(g(arg))  # compile + warm
        ts = []
        for i in range(1, 4):
            t0 = time.perf_counter()
            float(g(perturb(arg, i)))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    pert_d = lambda a, i: a + jnp.float32(i * 1e-6)  # noqa: E731
    pert_lq = lambda a, i: replace(  # noqa: E731
        a, knots=replace(a.knots, q=a.knots.q + jnp.float32(i * 1e-6))
    )

    phases = {
        "evaluate_ms": timed(phase_eval, d0, pert_d),
        "derivatives_ms": timed(phase_derivs, d0, pert_d),
        "assemble_ms": timed(phase_assemble, d0, pert_d),
        "lq_solve_ms": timed(phase_lq, lqs, pert_lq),
        "full_solve_ms": timed(phase_full, d0, pert_d),
    }
    # assemble includes a derivatives pass (XLA may CSE differently inside
    # the full solve); report the increment too
    phases["assemble_minus_derivs_ms"] = (
        phases["assemble_ms"] - phases["derivatives_ms"]
    )
    out = {
        "metric": "talos_walk_phase_profile",
        "unit": "ms/batch-call",
        "batch": batch,
        "nsteps": N,
        "ndx": ndx,
        **{k: round(v * 1e3, 2) for k, v in phases.items()},
    }
    print(json.dumps(out))


def profile_onchip(batch=16):
    """Dispatch-overhead-free per-phase profile.

    Each phase runs K repetitions inside ONE compiled ``lax.scan`` (inputs
    perturbed per repetition so no dispatch can be served from a cache);
    the reported per-call time is ``(t(K_hi) − t(K_lo)) / (K_hi − K_lo)``,
    which cancels all fixed dispatch overhead.
    Finer sub-phases decompose evaluate/derivatives into the contact-KKT
    primal solve, the analytic RBD derivative pass, cost derivatives and
    constraint Jacobians, so the saturating component is identified
    on-chip (reference per-zone Tracy profile of ``bench/talos-walk.cpp``).
    """
    from aligator_tpu.core import problem as problem_mod
    from aligator_tpu.gar import riccati

    problem, model, sched = create_talos_walk_problem(
        t_ds=4, t_ss=10, dtype=jnp.float32
    )
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
        rollout="linear", ls_max_steps=6, force_initial_condition=True,
    )
    N = problem.nsteps
    nu = problem.nu
    nq, nv = model.nq, model.nv
    dtype = jnp.float32
    x0 = problem.x0
    d0 = 0.01 * jax.random.normal(
        jax.random.PRNGKey(0), (batch, model.nv), dtype
    )

    def iterates(dvi):
        x0i = x0.at[nq:].add(dvi)
        xs = jnp.broadcast_to(x0i, (N + 1,) + x0i.shape)
        us = jnp.zeros((N, nu), dtype)
        return x0i, xs, us

    stage0 = problem.stages  # stacked (N, ...) stage pytree

    def per_stage(fn, dvi):
        """vmap fn(stage, x, u) over the N stacked stages at the initial
        iterate (the same evaluation pattern as problem.evaluate)."""
        x0i, xs, us = iterates(dvi)
        return jax.vmap(fn)(stage0, xs[:N], us)

    def phase_eval(dvi):
        x0i, xs, us = iterates(dvi)
        data = problem_mod.evaluate(replace(problem, x0=x0i), xs, us)
        return data.cost + data.cstr_vals.sum() + data.dyn_res.sum()

    def phase_derivs(dvi):
        x0i, xs, us = iterates(dvi)
        data = problem_mod.compute_derivatives(
            replace(problem, x0=x0i), xs, us
        )
        return data.Lx.sum() + data.A.sum() + data.cstr_Jx.sum()

    # --- sub-phases ---
    def phase_cfd(dvi):  # contact-KKT forward dynamics (the evaluate core)
        out = per_stage(
            lambda st, x, u: st.dynamics.forward(problem.space, x, u), dvi
        )
        return out.sum()

    def phase_dyn_jac(dvi):  # analytic (A, B, E) assembly
        outs = per_stage(
            lambda st, x, u: st.dynamics.jacobians(
                problem.space, x, u, problem.space.integrate(
                    x, jnp.zeros((problem.space.ndx,), dtype))
            ),
            dvi,
        )
        return sum(o.sum() for o in outs)

    def phase_cost_derivs(dvi):  # cost gradients + hessians
        def f(st, x, u):
            gx, gu = st.cost.gradients(problem.space, x, u)
            Hxx, Hxu, Huu = st.cost.hessians(problem.space, x, u)
            return gx.sum() + gu.sum() + Hxx.sum() + Hxu.sum() + Huu.sum()

        return per_stage(f, dvi).sum()

    def phase_cstr_jac(dvi):  # constraint jacobians (control box)
        def f(st, x, u):
            Jx, Ju = st.constraint_jacobians(x, u)
            return Jx.sum() + Ju.sum()

        return per_stage(f, dvi).sum()

    def phase_lq(dvi):
        # assemble outside? No — assembly is cheap (r4: 0.22 ms); keep the
        # LQ phase downstream of a fresh assemble so perturbations flow.
        from aligator_tpu.solvers import proxddp as P
        import types

        x0i, xs, us = iterates(dvi)
        prob_i = replace(problem, x0=x0i)
        data = problem_mod.compute_derivatives(prob_i, xs, us)
        mu = jnp.asarray(cfg.mu_init, dtype)
        st_like = types.SimpleNamespace(
            mu=mu,
            prev_lams=jnp.zeros((N + 1, problem.space.ndx), dtype),
            prev_vs=jnp.zeros((N, problem.nc), dtype),
            prev_vs_term=jnp.zeros((problem.nc_term,), dtype),
        )
        m = P._compute_multipliers(
            prob_i, cfg, data, st_like,
            st_like.prev_lams, st_like.prev_vs, st_like.prev_vs_term,
        )
        Lxs, Lus = P._lagrangian_grads(
            prob_i, cfg, data, st_like.prev_lams, st_like.prev_vs,
            st_like.prev_vs_term,
        )
        lq = P._assemble_lq(
            prob_i, cfg, data, m, Lxs, Lus, jnp.asarray(1e-9, dtype), mu
        )
        f = riccati.backward(lq, cfg.dyn_al_scale * mu, mu, True)
        xs_, us_, vs_, lams_ = riccati.forward(f)
        return xs_.sum() + us_.sum()

    def phase_full(dvi):
        res = solvers.solve(replace(problem, x0=x0.at[nq:].add(dvi)), cfg)
        return res.us.sum() + res.prim_infeas

    def timed_onchip(fn, k_lo, k_hi, reps=3):
        def batched(dvi_b):
            return jax.vmap(fn)(dvi_b).sum()

        def runner(K):
            @jax.jit
            def run(d):
                def body(acc, i):
                    return acc + batched(d + (1e-6 * i).astype(dtype)), None

                acc, _ = jax.lax.scan(
                    body, jnp.zeros((), dtype), jnp.arange(K, dtype=dtype)
                )
                return acc

            return run

        run_lo, run_hi = runner(k_lo), runner(k_hi)
        float(run_lo(d0))  # compile
        float(run_hi(d0))
        t_lo = t_hi = float("inf")
        for i in range(1, reps + 1):
            dd = d0 + jnp.float32(i * 1e-7)
            t0 = time.perf_counter()
            float(run_lo(dd))
            t_lo = min(t_lo, time.perf_counter() - t0)
            t0 = time.perf_counter()
            float(run_hi(dd))
            t_hi = min(t_hi, time.perf_counter() - t0)
        return (t_hi - t_lo) / (k_hi - k_lo)

    phases = {}
    for name, fn, klo, khi in [
        ("evaluate_ms", phase_eval, 1, 9),
        ("derivatives_ms", phase_derivs, 1, 9),
        ("cfd_forward_ms", phase_cfd, 1, 9),
        ("dyn_jacobians_ms", phase_dyn_jac, 1, 9),
        ("cost_derivs_ms", phase_cost_derivs, 1, 9),
        ("cstr_jac_ms", phase_cstr_jac, 1, 9),
        ("lq_after_derivs_ms", phase_lq, 1, 5),
        ("full_solve_ms", phase_full, 1, 3),
    ]:
        phases[name] = timed_onchip(fn, klo, khi)
        print(f"# {name}: {phases[name] * 1e3:.2f}", flush=True)
    phases["lq_solve_ms"] = (
        phases["lq_after_derivs_ms"] - phases["derivatives_ms"]
    )
    out = {
        "metric": "talos_walk_phase_profile_onchip",
        "unit": "ms/batch-call",
        "batch": batch,
        "nsteps": N,
        "ndx": problem.space.ndx,
        **{k: round(v * 1e3, 3) for k, v in phases.items()},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    if "--onchip" in sys.argv:
        sys.argv.remove("--onchip")
        profile_onchip(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
    elif "--profile" in sys.argv:
        sys.argv.remove("--profile")
        profile(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
    else:
        main()
