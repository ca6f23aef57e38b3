"""FDDP tests (reference ``tests/python/test_solver.py:40-127``: FDDP on LQR
converges in 2 iterations; agreement with ProxDDP on unconstrained problems)."""

import jax
import jax.numpy as jnp

from aligator_tpu import solvers
from aligator_tpu.solvers import fddp
from tests.test_proxddp import make_lqr


def test_fddp_lqr_two_iters():
    problem = make_lqr(nsteps=20)
    res = fddp.solve(problem, fddp.FDDPConfig(tol=1e-7, max_iters=10))
    assert bool(res.conv)
    assert int(res.num_iters) <= 2
    assert float(res.prim_infeas) < 1e-7
    assert float(res.dual_infeas) < 1e-7


def test_fddp_matches_proxddp_unconstrained():
    problem = make_lqr(nsteps=30)
    r1 = fddp.solve(problem, fddp.FDDPConfig(tol=1e-9, max_iters=20))
    r2 = solvers.solve(problem, solvers.ProxDDPConfig(tol=1e-9, max_iters=20))
    assert bool(r1.conv) and bool(r2.conv)
    assert float(jnp.max(jnp.abs(r1.us - r2.us))) < 1e-6


def test_fddp_se2_car():
    from examples.se2_car import create_se2_problem

    problem = create_se2_problem(nsteps=30, dtype=jnp.float64)
    res = fddp.solve(problem, fddp.FDDPConfig(tol=1e-6, max_iters=50))
    assert bool(res.conv)
    assert float(res.prim_infeas) < 1e-6


def test_fddp_jit_vmap():
    from aligator_tpu._pytree import replace

    problem = make_lqr(nsteps=15)
    cfg = fddp.FDDPConfig(tol=1e-7, max_iters=10)

    @jax.jit
    def batch(x0s):
        return jax.vmap(lambda x0: fddp.solve(replace(problem, x0=x0), cfg))(x0s)

    x0s = jnp.array([[1.0, 0.0], [-0.5, 0.25]], jnp.float64)
    res = batch(x0s)
    assert bool(jnp.all(res.conv))


def test_fddp_parity_oracle_lqr():
    """JAX FDDP vs the independent NumPy FDDP oracle on LQR: identical
    iteration count, matching final controls (the reference cross-solver
    test strategy extended to the second solver)."""
    import numpy as np

    from aligator_tpu.oracle import NumpyFDDP

    problem = make_lqr(nsteps=25)
    cfg = fddp.FDDPConfig(tol=1e-9, max_iters=30, record_history_trajs=True)
    res = fddp.solve(problem, cfg)
    tr = NumpyFDDP(problem, cfg).solve()
    assert bool(res.conv) and tr.conv
    assert int(res.num_iters) == tr.num_iters
    # the reference expects 2-iteration convergence on LQR
    # (tests/python/test_solver.py:40)
    assert int(res.num_iters) == 2
    # iterate-for-iterate: the oracle records post-step iterates, the JAX
    # trace records top-of-iteration iterates — offset by one
    for k, u_o in enumerate(tr.us_hist):
        du = np.max(np.abs(np.asarray(res.history_us[k + 1]) - u_o))
        assert du < 1e-10, f"iterate {k}: {du}"
    assert np.max(np.abs(np.asarray(res.us) - tr.us)) < 1e-8
    assert np.max(np.abs(np.asarray(res.xs) - tr.xs)) < 1e-8


def test_fddp_parity_oracle_cartpole():
    """Nonlinear workload: unconstrained cartpole swing-up — the oracle's
    gap-contracting rollout and expected-improvement linesearch must make
    the same accept/contract decisions as the vectorized solver."""
    import numpy as np

    from aligator_tpu.oracle import NumpyFDDP
    from examples.cartpole import create_cartpole_problem

    problem = create_cartpole_problem(nsteps=40, u_bound=None)
    cfg = fddp.FDDPConfig(tol=1e-6, max_iters=60, record_history_trajs=True)
    res = fddp.solve(problem, cfg)
    tr = NumpyFDDP(problem, cfg).solve()
    assert bool(res.conv) and tr.conv
    assert int(res.num_iters) == tr.num_iters
    # iterate-for-iterate (post-step vs top-of-iteration offset); the
    # early iterates must track tightly, tolerance loosens as fp
    # accumulation differs between the two routes
    for k, u_o in enumerate(tr.us_hist):
        if k + 1 < int(res.num_iters):
            du = np.max(np.abs(np.asarray(res.history_us[k + 1]) - u_o))
            assert du < 1e-6 * (10.0 ** min(k, 3)), f"iterate {k}: {du}"
    assert np.max(np.abs(np.asarray(res.us) - tr.us)) < 1e-4
    assert np.max(np.abs(np.asarray(res.xs) - tr.xs)) < 1e-4


def test_fddp_history_verbose_callback(capsys):
    """FDDP observability parity with ProxDDP (VERDICT r2 item 8): the
    reference drives the same Logger/HistoryCallback machinery for both
    solvers (solver-fddp.hxx logs per iteration like solver-proxddp.hxx)."""
    problem = make_lqr(nsteps=20)
    rows = []
    cfg = fddp.FDDPConfig(
        tol=1e-9, max_iters=10, record_history=True, verbose=True,
        callback=rows.append,
    )
    res = fddp.solve(problem, cfg)
    jax.block_until_ready(res.xs)
    jax.effects_barrier()
    assert bool(res.conv)
    n = int(res.num_iters)
    assert res.history.shape == (10, 6)
    h = res.history[:n]
    # prim/dual decrease to convergence; alpha of the accepted steps recorded
    assert float(h[-1, 0]) < 1e-9 or float(res.prim_infeas) < 1e-9
    assert len(rows) == n
    assert {"iter", "alpha", "prim_err", "dual_err", "cost"} <= set(rows[0])
    out = capsys.readouterr().out
    assert "prim_err" in out and "dual_err" in out  # header printed
    assert out.count("\n") >= n  # one row per iteration


def test_fddp_backward_medium_dims_batched():
    """FDDP's backward pass at nx=36 (the humanoid dims) under vmap: its
    joint feedforward/feedback SPD solve is ``smallmat.solve_spd`` on every
    backend. On an LQR the first Newton step is exact, so two iterations
    reach the ProxDDP optimum for every scenario."""
    from aligator_tpu._pytree import replace
    from bench_lqr import make_dense_lqr

    problem = make_dense_lqr(nx=36, nu=12, nsteps=8, dtype=jnp.float64)
    x0s = problem.x0 + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (3, 36), jnp.float64
    )
    r_f = jax.vmap(
        lambda x0: fddp.solve(
            replace(problem, x0=x0), fddp.FDDPConfig(tol=1e-8, max_iters=2)
        )
    )(x0s)
    r_p = jax.vmap(
        lambda x0: solvers.solve(
            replace(problem, x0=x0),
            solvers.ProxDDPConfig(tol=1e-9, max_iters=20),
        )
    )(x0s)
    assert bool(jnp.all(r_f.conv))
    assert float(jnp.max(jnp.abs(r_f.us - r_p.us))) < 1e-6
