"""ProxDDP solver tests (counterpart of reference
``tests/python/test_solver.py``): LQR convergence, box-constrained LQR with
both rollout types, terminal equality constraints, batched solves."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from aligator_tpu import core, solvers
from aligator_tpu._pytree import replace


def make_lqr(nsteps=20, u_bound=None, dtype=jnp.float64):
    dt_ = 0.1
    space = core.VectorSpace(2)
    nu = 1
    A = jnp.array([[1.0, dt_], [0.0, 1.0]], dtype)
    B = jnp.array([[0.0], [dt_]], dtype)
    dyn = core.LinearDiscreteDynamics(A=A, B=B, c=jnp.zeros((2,), dtype))
    cost = core.QuadraticCost.create(
        0.001 * jnp.eye(2, dtype=dtype), 0.001 * jnp.eye(1, dtype=dtype)
    )
    term_cost = core.QuadraticCost.create(
        10.0 * jnp.eye(2, dtype=dtype), jnp.zeros((1, 1), dtype)
    )
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
    return core.make_problem(
        jnp.array([1.0, 0.0], dtype), stage, nsteps, term_cost
    )


def test_lqr_converges_fast():
    problem = make_lqr(nsteps=100)
    res = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-8, max_iters=10))
    assert bool(res.conv)
    assert int(res.num_iters) <= 5
    assert float(res.prim_infeas) < 1e-8
    assert float(res.dual_infeas) < 1e-8


def test_lqr_matches_dense_kkt():
    """Unconstrained LQR: ProxDDP solution must satisfy the exact first-order
    conditions (costate recursion + input stationarity)."""
    problem = make_lqr(nsteps=30)
    res = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-10, max_iters=10))
    stage = problem.stage_at(0)
    A, B = stage.dynamics.A, stage.dynamics.B
    Q = stage.cost.residual if False else None
    xs, us, lams = res.xs, res.us, res.lams
    # dynamics feasibility
    xerr = xs[1:] - (xs[:-1] @ A.T + us @ B.T)
    assert float(jnp.max(jnp.abs(xerr))) < 1e-8
    # stationarity in u: R u + B' λ_{t+1} = 0  (R = 0.001 I)
    # costates solved by the proximal system: E'λ = -λ (E=-I)
    ru = 0.001 * us + lams[1:] @ B
    assert float(jnp.max(jnp.abs(ru))) < 1e-6


@pytest.mark.parametrize("rollout", ["linear", "nonlinear"])
def test_box_constrained_lqr(rollout):
    problem = make_lqr(nsteps=20, u_bound=0.1)
    cfg = solvers.ProxDDPConfig(tol=1e-8, max_iters=150, rollout=rollout)
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)
    assert float(jnp.max(jnp.abs(res.us))) <= 0.1 + 1e-7
    # the bound must actually be active somewhere for this config
    assert float(jnp.max(jnp.abs(res.us))) > 0.0999


def test_rollout_types_agree():
    problem = make_lqr(nsteps=20, u_bound=0.1)
    r1 = solvers.solve(
        problem, solvers.ProxDDPConfig(tol=1e-8, max_iters=150, rollout="linear")
    )
    r2 = solvers.solve(
        problem,
        solvers.ProxDDPConfig(tol=1e-8, max_iters=150, rollout="nonlinear"),
    )
    assert bool(r1.conv) and bool(r2.conv)
    assert float(jnp.max(jnp.abs(r1.us - r2.us))) < 1e-7


def test_terminal_equality_constraint():
    problem = make_lqr(nsteps=30)
    target = jnp.array([0.25, -0.1], jnp.float64)
    tc = (
        core.StateErrorResidual(target=target),
        core.EqualityConstraint(),
    )
    problem = replace(
        problem, term_constraints=(tc,), term_cstr_dims=(2,)
    )
    res = solvers.solve(
        problem, solvers.ProxDDPConfig(tol=1e-9, max_iters=100)
    )
    assert bool(res.conv)
    assert float(jnp.max(jnp.abs(res.xs[-1] - target))) < 1e-7


def test_batched_vmap_jit():
    problem = make_lqr(nsteps=20, u_bound=0.15)
    cfg = solvers.ProxDDPConfig(tol=1e-6, max_iters=120)

    @jax.jit
    def solve_batch(x0s):
        return jax.vmap(lambda x0: solvers.solve(replace(problem, x0=x0), cfg))(
            x0s
        )

    x0s = jnp.array([[1.0, 0.0], [-1.0, 0.5], [0.3, -0.2]], jnp.float64)
    res = solve_batch(x0s)
    assert res.us.shape == (3, 20, 1)
    assert bool(jnp.all(res.conv))
    assert float(jnp.max(jnp.abs(res.us))) <= 0.15 + 1e-6


def test_stage_varying_costs():
    """Per-stage parameter heterogeneity through stacked stage leaves."""
    problem = make_lqr(nsteps=10)
    # make the control weight grow over time
    stages = problem.stages
    w = jnp.linspace(1.0, 5.0, 10)[:, None, None]
    # QuadraticCost R leaf is stages.cost.R with shape (10, 1, 1)
    stages = replace(stages, cost=replace(stages.cost, R=stages.cost.R * w))
    problem = replace(problem, stages=stages)
    res = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-8, max_iters=20))
    assert bool(res.conv)


@pytest.mark.parametrize("strategy", ["nonmonotone", "armijo", "filter"])
def test_all_step_acceptance_strategies(strategy):
    """Reference test_solver.py: box-constrained LQR with all 3 step
    acceptance strategies."""
    problem = make_lqr(nsteps=20, u_bound=0.1)
    cfg = solvers.ProxDDPConfig(tol=1e-8, max_iters=150, ls_strategy=strategy)
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)
    assert float(jnp.max(jnp.abs(res.us))) <= 0.1 + 1e-6


@pytest.mark.parametrize("mode", ["newton", "primal", "primal_dual"])
def test_multiplier_update_modes(mode):
    problem = make_lqr(nsteps=20, u_bound=0.1)
    cfg = solvers.ProxDDPConfig(
        tol=1e-8, max_iters=150, multiplier_update_mode=mode
    )
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)


def test_parallel_linear_solver_matches_serial():
    """ProxDDP with the parallel-in-time LQ solver (reference
    LQSolverChoice::PARALLEL) produces the same iterates as serial."""
    problem = make_lqr(nsteps=19, u_bound=0.2)  # T = 20, legs = 4
    cfg_s = solvers.ProxDDPConfig(tol=1e-8, max_iters=100)
    cfg_p = solvers.ProxDDPConfig(
        tol=1e-8, max_iters=100, linear_solver="parallel", parallel_legs=4
    )
    r1 = solvers.solve(problem, cfg_s)
    r2 = solvers.solve(problem, cfg_p)
    assert bool(r1.conv) and bool(r2.conv)
    assert float(jnp.max(jnp.abs(r1.us - r2.us))) < 1e-9


def test_bench_protocol_se2_car_fp32():
    """Regression guard for the headline benchmark workload: the SE(2)-car
    problem (bench/se2-car.cpp protocol) must converge quickly in fp32."""
    from examples.se2_car import create_se2_problem

    problem = create_se2_problem(nsteps=50, dtype=jnp.float32)
    cfg = solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=10, max_al_iters=10,
        rollout="linear", ls_max_steps=6,
    )
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)
    assert int(res.num_iters) <= 8
    assert bool(jnp.isfinite(res.us).all())


def test_parallel_gains_in_results():
    """The parallel LQ path must return usable feedback gains (reference
    collapseFeedback, parallel-solver.hpp:55-66): stage-0 feedback equals
    the serial path's."""
    problem = make_lqr(nsteps=19, u_bound=0.2)
    cfg_s = solvers.ProxDDPConfig(tol=1e-8, max_iters=100)
    cfg_p = solvers.ProxDDPConfig(
        tol=1e-8, max_iters=100, linear_solver="parallel", parallel_legs=4
    )
    r1 = solvers.solve(problem, cfg_s)
    r2 = solvers.solve(problem, cfg_p)
    assert float(jnp.max(jnp.abs(r2.K))) > 0.0  # not stale zeros
    assert float(jnp.max(jnp.abs(r1.K[0] - r2.K[0]))) < 1e-8
    # last-leg gains are unparameterized and match serial too (results.K
    # drops the terminal knot, so the last leg contributes 4 rows here;
    # interface-knot gains are θ-parameterized by design and differ)
    assert float(jnp.max(jnp.abs(r1.K[-4:] - r2.K[-4:]))) < 1e-8


@pytest.mark.parametrize("interp", ["bisection", "quadratic", "cubic"])
def test_ls_interp_variants(interp):
    """Armijo with polynomial step interpolation (reference
    linesearch-armijo.hpp:45-120) converges on the box-constrained LQR."""
    problem = make_lqr(nsteps=20, u_bound=0.1)
    cfg = solvers.ProxDDPConfig(
        tol=1e-8, max_iters=150, ls_strategy="armijo", ls_interp=interp
    )
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)
    assert float(jnp.max(jnp.abs(res.us))) <= 0.1 + 1e-6


@pytest.mark.slow
def test_dynamics_vhp_finite_differences():
    """Costate-contracted dynamics VHPs (exact-Hessian mode) match finite
    differences of λᵀr (reference computeVectorHessianProducts,
    core/dynamics.hpp:66)."""
    from examples.pendulum import create_pendulum_problem

    problem = create_pendulum_problem(nsteps=5)
    space = problem.space
    N = problem.nsteps
    key = jax.random.PRNGKey(0)
    xs = 0.3 * jax.random.normal(key, (N + 1, 2), jnp.float64)
    us = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (N, 1), jnp.float64)
    lams = jax.random.normal(jax.random.PRNGKey(2), (N + 1, 2), jnp.float64)

    Hxx, Hxu, Huu = core.problem.dynamics_vhp(problem, xs, us, lams[1:])

    t = 2
    stage = problem.stage_at(t)
    eps = 1e-5

    def g(z):
        dx, du = z[:2], z[2:]
        r = stage.dynamics.residual(
            space, space.integrate(xs[t], dx), us[t] + du, xs[t + 1]
        )
        return float(lams[t + 1] @ r)

    import numpy as np

    nz = 3
    H_fd = np.zeros((nz, nz))
    for i in range(nz):
        for j in range(nz):
            zpp = np.zeros(nz); zpp[i] += eps; zpp[j] += eps
            zpm = np.zeros(nz); zpm[i] += eps; zpm[j] -= eps
            zmp = np.zeros(nz); zmp[i] -= eps; zmp[j] += eps
            zmm = np.zeros(nz); zmm[i] -= eps; zmm[j] -= eps
            H_fd[i, j] = (g(zpp) - g(zpm) - g(zmp) + g(zmm)) / (4 * eps * eps)
    H = np.block(
        [
            [np.asarray(Hxx[t]), np.asarray(Hxu[t])],
            [np.asarray(Hxu[t]).T, np.asarray(Huu[t])],
        ]
    )
    assert np.allclose(H, H_fd, atol=1e-5)


@pytest.mark.slow
def test_exact_hessian_mode():
    """hessian_approx='exact' (reference HessianApprox::EXACT): on the
    pendulum swing-up at tight tolerance, Gauss-Newton stalls (hits
    max_iters) while the exact-Hessian Newton converges quadratically —
    and both land on the same solution."""
    from examples.pendulum import create_pendulum_problem

    problem = create_pendulum_problem(nsteps=30)
    base = dict(tol=1e-6, max_iters=200, rollout="nonlinear")
    r_gn = solvers.solve(problem, solvers.ProxDDPConfig(**base))
    r_ex = solvers.solve(
        problem, solvers.ProxDDPConfig(**base, hessian_approx="exact")
    )
    assert bool(r_ex.conv)
    assert int(r_ex.num_iters) < 50
    assert int(r_ex.num_iters) < int(r_gn.num_iters)
    # GN's 200-iteration iterate agrees with the exact solution
    assert float(jnp.max(jnp.abs(r_ex.us - r_gn.us))) < 1e-4


def test_rollout_newton_iters_midpoint():
    """Implicit midpoint under the nonlinear rollout: with enough in-rollout
    Newton iterations (rollout_max_iters, reference solver-proxddp.hxx:84)
    the solution matches the linear-rollout one."""
    from aligator_tpu.modelling import IntegratorMidpoint
    from aligator_tpu.modelling.dynamics.ode import LinearODE

    dtype = jnp.float64
    space = core.VectorSpace(2)
    Ac = jnp.array([[0.0, 1.0], [-4.0, -0.4]], dtype)
    Bc = jnp.array([[0.0], [1.0]], dtype)
    ode = LinearODE(A=Ac, B=Bc, c=jnp.zeros(2, dtype))
    dyn = IntegratorMidpoint(ode=ode, timestep=jnp.asarray(0.08, dtype))
    cost = core.QuadraticCost.create(
        0.01 * jnp.eye(2, dtype=dtype), 0.01 * jnp.eye(1, dtype=dtype)
    )
    term_cost = core.QuadraticCost.create(
        jnp.eye(2, dtype=dtype) * 10.0, jnp.zeros((1, 1), dtype)
    )
    stage = core.make_stage(cost, dyn, space, 1)
    problem = core.make_problem(
        jnp.array([1.0, 0.0], dtype), stage, 25, term_cost
    )
    r_lin = solvers.solve(
        problem, solvers.ProxDDPConfig(tol=1e-9, max_iters=60)
    )
    r_nl = solvers.solve(
        problem,
        solvers.ProxDDPConfig(
            tol=1e-9, max_iters=60, rollout="nonlinear", rollout_max_iters=4
        ),
    )
    assert bool(r_lin.conv) and bool(r_nl.conv)
    assert float(jnp.max(jnp.abs(r_lin.us - r_nl.us))) < 1e-7


def test_no_retrace_across_calls():
    """JAX analog of the reference's nomalloc guard (tests/nomalloc.cpp:7,
    CHECK_RUNTIME_MALLOC): the jitted solve must not re-trace or re-compile
    when called again with different VALUES of the same shapes — retraces
    are the accelerator equivalent of per-iteration heap allocation."""
    problem = make_lqr(nsteps=10, u_bound=0.4)
    cfg = solvers.ProxDDPConfig(tol=1e-6, max_iters=20)

    n_trace = 0

    @jax.jit
    def run(p):
        nonlocal n_trace
        n_trace += 1
        return solvers.solve(p, cfg)

    from aligator_tpu._pytree import replace as _replace

    r1 = run(problem)
    r2 = run(_replace(problem, x0=jnp.array([-0.3, 0.8], jnp.float64)))
    assert bool(r1.conv) and bool(r2.conv)
    assert n_trace == 1
    assert run._cache_size() == 1


@pytest.mark.slow
def test_filter_eviction_when_pool_full():
    """With a tiny filter pool the solver must still converge: when the pool
    fills, the max-merit (least binding) entry is evicted rather than
    silently overwriting slot 0 (the reference's filter is an unbounded
    vector append, core/filter.hpp:42-105)."""
    from examples.se2_car import create_se2_problem

    problem = create_se2_problem(nsteps=20, dtype=jnp.float64)
    cfg = solvers.ProxDDPConfig(
        tol=1e-6, mu_init=1e-2, max_iters=30, ls_strategy="filter",
        filter_size=2,
    )
    res = solvers.solve(problem, cfg)
    assert bool(res.conv)
    # matches the large-pool solution
    cfg_big = dataclasses.replace(cfg, filter_size=40)
    res_big = solvers.solve(problem, cfg_big)
    assert jnp.allclose(res.us, res_big.us, atol=1e-5)
