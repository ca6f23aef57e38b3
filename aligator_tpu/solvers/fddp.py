"""FDDP: feasible differential dynamic programming (Crocoddyl-style).

Counterpart of ``SolverFDDPTpl`` (reference
``include/aligator/solvers/fddp/solver-fddp.hxx``): unconstrained DDP with
multiple-shooting gaps, a gap-contracting forward pass, Q-function
regularization, and the Mastalli et al. "Goldstein-like" backtracking
linesearch driven by an expected-improvement model
(``solvers/fddp/linesearch.hpp:17``).

Constraints are ignored (warn at build, reference ``solver-fddp.hxx:36-55``);
use ProxDDP for constrained problems. The whole solve is one
`lax.while_loop`, jit/vmap-compatible.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .._precision import highest_precision
from .._pytree import pytree_dataclass, replace
from ..core import problem as problem_mod
from ..gar import smallmat
from ..core.problem import TrajOptProblem
from ..utils import logger as logger_mod


@pytree_dataclass
class _St:
    xs: jax.Array
    us: jax.Array
    cost: jax.Array
    preg: jax.Array
    iter: jax.Array
    conv: jax.Array
    fail: jax.Array
    prim: jax.Array
    dual: jax.Array
    K: jax.Array
    kff: jax.Array
    alpha_last: jax.Array
    d1_last: jax.Array
    history: jax.Array  # (max_iters, 6) or (0, 6)
    hist_xs: jax.Array  # (max_iters, N+1, nx) or (0, ...)
    hist_us: jax.Array  # (max_iters, N, nu) or (0, ...)


@dataclasses.dataclass(frozen=True)
class FDDPConfig:
    tol: float = 1e-6
    max_iters: int = 200
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc_factor: float = 10.0
    reg_dec_factor: float = 0.1
    th_grad: float = 1e-12
    th_step_dec: float = 0.5
    th_step_inc: float = 0.01
    th_accept_step: float = 0.1
    th_accept_neg_step: float = 2.0
    ls_alpha_min: float = 2.0**-9
    ls_beta: float = 0.5
    # observability, mirroring ProxDDPConfig (the reference drives the same
    # Logger/HistoryCallback machinery for both solvers — solver-fddp.hxx
    # logs per iteration like solver-proxddp.hxx:708-721):
    # per-iteration [prim, dual, cost, alpha, preg, d1] rows
    record_history: bool = False
    # full xs/us iterate traces per iteration (HistoryCallback
    # store_primal=true parity, matching ProxDDPConfig.record_history_trajs)
    record_history_trajs: bool = False
    # columnar trace rows printed from inside jit via jax.debug.callback
    verbose: bool = False
    # host Python hook called with the per-iteration trace dict
    callback: Optional[Callable[[dict], None]] = None


@pytree_dataclass
class FDDPResults:
    xs: jax.Array
    us: jax.Array
    conv: jax.Array
    num_iters: jax.Array
    prim_infeas: jax.Array
    dual_infeas: jax.Array
    traj_cost: jax.Array
    K: Optional[jax.Array] = None
    kff: Optional[jax.Array] = None
    # (max_iters, 6) [prim, dual, cost, alpha, preg, d1] when record_history
    history: Optional[jax.Array] = None
    # full iterate traces (record_history_trajs)
    history_xs: Optional[jax.Array] = None
    history_us: Optional[jax.Array] = None


@highest_precision
def solve(
    problem: TrajOptProblem,
    cfg: FDDPConfig = FDDPConfig(),
    xs_init: Optional[jax.Array] = None,
    us_init: Optional[jax.Array] = None,
) -> FDDPResults:
    if problem.nc > 0 or problem.nc_term > 0:
        warnings.warn(
            "FDDP cannot handle constraints; they will be IGNORED "
            "(reference solver-fddp.hxx:36-55). Use ProxDDP instead."
        )
    space = problem.space
    N = problem.nsteps
    ndx, nu = space.ndx, problem.nu
    dtype = problem.x0.dtype

    if xs_init is None:
        xs_init = jnp.broadcast_to(problem.x0, (N + 1,) + problem.x0.shape)
    if us_init is None:
        us_init = jnp.zeros((N, nu), dtype)

    def compute_gaps(xs, us):
        f0 = space.difference(xs[0], problem.x0)

        def one(stage, x, u, y):
            xnext = stage.dynamics.forward(space, x, u)
            return space.difference(y, xnext), xnext

        fs_rest, xnexts = jax.vmap(one)(problem.stages, xs[:N], us, xs[1:])
        return jnp.concatenate([f0[None], fs_rest], axis=0), xnexts

    def backward(data, fs, preg):
        """Backward DDP sweep (reference backwardPass, solver-fddp.hxx:203).

        Returns per-stage gains and the quantities for the expected
        improvement model."""
        eye_x = jnp.eye(ndx, dtype=dtype)
        VxxN = data.Lxx[N] + preg * eye_x
        ftVxxN = VxxN @ fs[N]
        VxN = data.Lx[N] + ftVxxN

        # transition Jacobians with the E-correction (croco convention
        # Fx dx = dy): Fx = -E^{-1} A, Fu = -E^{-1} B
        def trans(A, B, E):
            F = jnp.linalg.solve(-E, jnp.concatenate([A, B], axis=1))
            return F[:, :ndx], F[:, ndx:]

        Fx, Fu = jax.vmap(trans)(data.A, data.B, data.E)

        def body(carry, inp):
            Vx, Vxx = carry
            Lx, Lu, Lxx, Lxu, Luu, Fx_t, Fu_t, f_t = inp
            Qx = Lx + Fx_t.T @ Vx
            Qu = Lu + Fu_t.T @ Vx
            FxV = Fx_t.T @ Vxx
            FuV = Fu_t.T @ Vxx
            Qxx = Lxx + FxV @ Fx_t
            Qxu = Lxu + FxV @ Fu_t
            Quu = Luu + FuV @ Fu_t + preg * jnp.eye(nu, dtype=dtype)
            # joint feedforward+feedback solve against ONE SPD multi-RHS
            # traversal: unrolled Cholesky in-scan instead of LAPACK
            # cho_factor/cho_solve, per the smallmat convention
            sol = smallmat.solve_spd(
                0.5 * (Quu + Quu.T),
                jnp.concatenate([Qu[:, None], Qxu.T], axis=1),
            )
            kff = -sol[:, 0]
            Kfb = -sol[:, 1:]
            Vx_new = Qx + Kfb.T @ Qu
            Vxx_new = Qxx + Qxu @ Kfb
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T) + preg * jnp.eye(
                ndx, dtype=dtype
            )
            ftVxx = Vxx_new @ f_t
            Vx_new = Vx_new + ftVxx
            Quuk = Quu @ kff
            out = dict(
                kff=kff, K=Kfb, Qu=Qu, Quuk=Quuk, Vx=Vx_new, Vxx=Vxx_new,
                ftVxx=ftVxx,
            )
            return (Vx_new, Vxx_new), out

        inps = (
            data.Lx[:N], data.Lu, data.Lxx[:N], data.Lxu, data.Luu,
            Fx, Fu, fs[:N],
        )
        (_, _), outs = lax.scan(body, (VxN, VxxN), inps, reverse=True)
        outs["ftVxxN"] = ftVxxN
        return outs

    def forward(xs, us, fs, bw, alpha):
        """Gap-contracting rollout (reference forwardPass,
        solver-fddp.hxx:58)."""
        dx0 = alpha * fs[0]
        x0_try = space.integrate(xs[0], dx0)

        def body(carry, inp):
            x_try, dx = carry
            stage, kff, K, x, y, u, f_next = inp
            du = alpha * kff + K @ dx
            u_try = u + du
            xnext = stage.dynamics.forward(space, x_try, u_try)
            x_next_try = space.integrate(xnext, (alpha - 1.0) * f_next)
            dx_next = space.difference(y, x_next_try)
            cost = stage.cost.value(space, x_try, u_try)
            return (x_next_try, dx_next), dict(
                x=x_try, u=u_try, dx=dx, cost=cost
            )

        inps = (
            problem.stages, bw["kff"], bw["K"], xs[:N], xs[1:], us, fs[1:]
        )
        (xN_try, dxN), outs = lax.scan(body, (x0_try, dx0), inps)
        u0 = jnp.zeros((nu,), dtype)
        tc = problem.term_cost.value(space, xN_try, u0)
        cost = jnp.sum(outs["cost"]) + tc
        xs_try = jnp.concatenate([outs["x"], xN_try[None]], axis=0)
        dxs = jnp.concatenate([outs["dx"], dxN[None]], axis=0)
        return xs_try, outs["u"], dxs, cost

    data0 = problem_mod.evaluate(problem, xs_init, us_init)
    st0 = _St(
        xs=xs_init,
        us=us_init,
        cost=data0.cost,
        preg=jnp.asarray(cfg.reg_init, dtype),
        iter=jnp.asarray(0, jnp.int32),
        conv=jnp.asarray(False),
        fail=jnp.asarray(False),
        prim=jnp.asarray(jnp.inf, dtype),
        dual=jnp.asarray(jnp.inf, dtype),
        K=jnp.zeros((N, nu, ndx), dtype),
        kff=jnp.zeros((N, nu), dtype),
        alpha_last=jnp.asarray(0.0, dtype),
        d1_last=jnp.asarray(0.0, dtype),
        history=jnp.zeros(
            (cfg.max_iters if cfg.record_history else 0, 6), dtype
        ),
        hist_xs=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N + 1)
            + problem.x0.shape,
            dtype,
        ),
        hist_us=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N, nu), dtype
        ),
    )

    def body(st: _St):
        data = problem_mod.compute_derivatives(problem, st.xs, st.us)
        fs, _ = compute_gaps(st.xs, st.us)
        prim = jnp.max(jnp.abs(fs))
        bw = backward(data, fs, st.preg)
        dual = jnp.max(jnp.abs(bw["Qu"]))
        st = replace(st, prim=prim, dual=dual, K=bw["K"], kff=bw["kff"])
        if cfg.record_history:
            row = jnp.stack(
                [prim, dual, data.cost, st.alpha_last, st.preg, st.d1_last]
            )
            st = replace(st, history=st.history.at[st.iter].set(row))
        if cfg.record_history_trajs:
            st = replace(
                st,
                hist_xs=st.hist_xs.at[st.iter].set(st.xs),
                hist_us=st.hist_us.at[st.iter].set(st.us),
            )
        if cfg.verbose or cfg.callback is not None:
            # per-iteration trace from inside jit (reference logs each FDDP
            # iteration with the shared Logger, solver-fddp.hxx)
            def _emit(it, alpha, prim_e, dual_e, cost_e, preg_e, d1_e):
                trace = {
                    "iter": int(it) + 1,
                    "alpha": float(alpha),
                    "prim_err": float(prim_e),
                    "dual_err": float(dual_e),
                    "preg": float(preg_e),
                    "dphi0": float(d1_e),
                    "cost": float(cost_e),
                }
                if cfg.verbose:
                    logger_mod.log_row(trace, header=trace["iter"] == 1)
                if cfg.callback is not None:
                    cfg.callback(trace)

            jax.debug.callback(
                _emit, st.iter, st.alpha_last, prim, dual, data.cost,
                st.preg, st.d1_last,
            )

        converged = jnp.maximum(prim, dual) < cfg.tol

        def step(st):
            phi0 = st.cost
            # expected improvement constants (updateExpectedImprovement,
            # solver-fddp.hxx:140)
            dg = jnp.sum(bw["Qu"] * bw["kff"]) + jnp.sum(
                bw["Vx"] * fs[:N]
            ) + bw["ftVxxN"] @ fs[N] + data.Lx[N] @ fs[N]
            # careful: Vx entries in bw are the *stage* Vx (indices 0..N-1);
            # the terminal Vx = Lx[N] + ftVxxN.
            dq = jnp.sum(bw["kff"] * bw["Quuk"]) - (
                jnp.sum(fs[:N] * bw["ftVxx"]) + fs[N] @ bw["ftVxxN"]
            )

            def try_alpha(alpha):
                xs_t, us_t, dxs, cost = forward(st.xs, st.us, fs, bw, alpha)
                # dv = -Σ dx·ftVxx  (expectedImprovement, solver-fddp.hxx:122)
                dv = -(
                    jnp.sum(dxs[:N] * bw["ftVxx"]) + dxs[N] @ bw["ftVxxN"]
                )
                d1 = dg + dv
                d2 = dq - 2.0 * dv
                model = phi0 + alpha * (d1 + 0.5 * d2 * alpha)
                return xs_t, us_t, cost, model, d1

            def ls_cond(carry):
                k, alpha, xs_t, us_t, cost, d1, accept = carry
                return jnp.logical_and(
                    jnp.logical_not(accept), alpha > cfg.ls_alpha_min * (1 + 1e-10)
                )

            def ls_check(alpha, cost, model, d1):
                dVreal = cost - phi0
                dVmodel = model - phi0
                ok_finite = jnp.isfinite(cost)
                descent = dVmodel < 0.0
                acc_desc = jnp.logical_or(
                    jnp.abs(d1) < cfg.th_grad,
                    dVreal <= cfg.th_accept_step * dVmodel,
                )
                acc_neg = dVreal <= cfg.th_accept_neg_step * dVmodel
                return jnp.logical_and(
                    ok_finite, jnp.where(descent, acc_desc, acc_neg)
                )

            def ls_body(carry):
                k, alpha, xs_t, us_t, cost, d1, accept = carry
                alpha2 = jnp.maximum(alpha * cfg.ls_beta, cfg.ls_alpha_min)
                xs2, us2, cost2, model2, d1_2 = try_alpha(alpha2)
                acc2 = ls_check(alpha2, cost2, model2, d1_2)
                return (k + 1, alpha2, xs2, us2, cost2, d1_2, acc2)

            xs1, us1, cost1, model1, d1_1 = try_alpha(jnp.asarray(1.0, dtype))
            acc1 = ls_check(jnp.asarray(1.0, dtype), cost1, model1, d1_1)
            k, alpha, xs_t, us_t, cost, d1, accept = lax.while_loop(
                ls_cond,
                ls_body,
                (jnp.asarray(0, jnp.int32), jnp.asarray(1.0, dtype), xs1, us1, cost1, d1_1, acc1),
            )

            # reject non-finite trials
            ok = jnp.isfinite(cost)
            xs_t = jnp.where(ok, xs_t, st.xs)
            us_t = jnp.where(ok, us_t, st.us)
            cost = jnp.where(ok, cost, st.cost)

            conv_grad = jnp.abs(d1) < cfg.th_grad

            preg = st.preg
            preg = jnp.where(
                alpha > cfg.th_step_dec,
                jnp.maximum(preg * cfg.reg_dec_factor, cfg.reg_min),
                preg,
            )
            inc = alpha <= cfg.th_step_inc
            preg = jnp.where(
                inc, jnp.minimum(preg * cfg.reg_inc_factor, cfg.reg_max), preg
            )
            fail = jnp.logical_and(inc, preg >= cfg.reg_max)

            return replace(
                st,
                xs=xs_t,
                us=us_t,
                cost=cost,
                preg=preg,
                conv=jnp.logical_or(st.conv, conv_grad),
                fail=jnp.logical_or(st.fail, fail),
                alpha_last=alpha,
                d1_last=d1,
            )

        st = lax.cond(
            converged, lambda s: replace(s, conv=jnp.asarray(True)), step, st
        )
        return replace(st, iter=st.iter + 1)

    def cond(st: _St):
        return jnp.logical_and(
            jnp.logical_and(st.iter < cfg.max_iters, jnp.logical_not(st.conv)),
            jnp.logical_not(st.fail),
        )

    st = lax.while_loop(cond, body, st0)

    # final metrics
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    fs, _ = compute_gaps(st.xs, st.us)
    bw = backward(data, fs, st.preg)
    prim = jnp.max(jnp.abs(fs))
    dual = jnp.max(jnp.abs(bw["Qu"]))
    conv = jnp.logical_or(st.conv, jnp.maximum(prim, dual) < cfg.tol)

    return FDDPResults(
        xs=st.xs,
        us=st.us,
        conv=conv,
        num_iters=st.iter,
        prim_infeas=prim,
        dual_infeas=dual,
        traj_cost=data.cost,
        K=bw["K"],
        kff=bw["kff"],
        history=st.history if cfg.record_history else None,
        history_xs=st.hist_xs if cfg.record_history_trajs else None,
        history_us=st.hist_us if cfg.record_history_trajs else None,
    )
