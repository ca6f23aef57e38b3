"""ProxDDP: proximal augmented-Lagrangian trajectory optimization.

Accelerator-native re-design of ``SolverProxDDPTpl`` (reference
``include/aligator/solvers/proxddp/solver-proxddp.hxx:458``). The reference's
nested control flow (outer BCL loop → inner Newton loop → linesearch) is
flattened into ONE ``lax.while_loop`` whose body performs a single Newton
iteration; the BCL (bound-constrained augmented Lagrangian) update fires
inside the body whenever the inner criterion is met. This keeps every
iteration fixed-shape, so the whole solver jits once and `vmap`s over
thousands of scenarios.

Key correspondences to the reference implementation:

* multiplier estimates / shifted constraints — ``computeMultipliers``
  (``solver-proxddp.hxx:210``)
* PDAL merit function — ``merit-function.hxx:31``
* Lagrangian gradients — ``core/lagrangian.hpp:26``
* LQ subproblem assembly — ``updateLQSubproblem`` (``solver-proxddp.hxx:802``)
  with active-set projected constraint Jacobians
  (``computeProjectedJacobians``, ``solver-proxddp.hxx:22``)
* Riccati solve — :mod:`aligator_tpu.gar`
* linear / nonlinear forward pass — ``tryLinearStep`` / ``tryNonlinearRollout``
  (``solver-proxddp.hxx:104,339``)
* Armijo backtracking linesearch — ``core/linesearch-armijo.hpp:60``
  (bisection contraction; fixed-shape `while_loop`)
* BCL tolerance schedule and inertia regularization —
  ``solver-proxddp.hpp:331-366``
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .._pytree import pytree_dataclass, replace
from ..utils import logger as logger_mod
from ..core import problem as problem_mod
from ..core.manifolds import VectorSpace
from ..core.problem import ProblemData, TrajOptProblem
from ..gar import associative as gar_associative
from ..gar import lqr_problem as lqr_mod
from ..gar import parallel as gar_parallel
from ..gar import riccati

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProxDDPConfig:
    """Solver hyper-parameters (static under jit).

    Defaults follow the reference (``solver-proxddp.hpp:102-196``)."""

    tol: float = 1e-6
    dual_tol: Optional[float] = None  # defaults to tol
    mu_init: float = 0.01
    max_iters: int = 100
    max_al_iters: int = 100
    # BCL params (AlmParams)
    prim_alpha: float = 0.1
    prim_beta: float = 0.9
    dual_alpha: float = 1.0
    dual_beta: float = 1.0
    mu_update_factor: float = 0.01
    dyn_al_scale: float = 1e-3
    mu_lower_bound: float = 1e-8
    # regularization schedule
    reg_min: float = 1e-10
    reg_max: float = 1e9
    reg_init: float = 1e-9
    reg_inc_k: float = 10.0
    reg_inc_first_k: float = 100.0
    reg_dec_k: float = 1.0 / 3.0
    # linesearch
    ls_armijo_c1: float = 1e-4
    ls_alpha_min: float = 1e-6
    ls_max_steps: int = 20
    ls_contraction: float = 0.5
    # step-size interpolation (reference linesearch-armijo.hpp:45-120):
    # 'bisection' | 'quadratic' | 'cubic' (reference default CUBIC). The
    # interpolated minimizer is safeguarded to
    # [ls_contraction_min*α, ls_contraction_max*α].
    ls_interp: str = "cubic"
    ls_contraction_min: float = 0.5
    ls_contraction_max: float = 0.8
    # step acceptance: 'nonmonotone' (Zhang-Hager moving average, the
    # reference default), 'armijo' (monotone backtracking), or 'filter'
    # (merit/infeasibility dominance filter, reference core/filter.hpp:12)
    ls_strategy: str = "nonmonotone"
    ls_avg_eta: float = 0.85
    filter_beta: float = 0.0
    filter_size: int = 40
    # multiplier update on BCL success (reference core/enums.hpp:23):
    # 'newton' | 'primal' | 'primal_dual'
    multiplier_update_mode: str = "newton"
    # Hessian approximation (reference HessianApprox, core/enums.hpp:14):
    # 'gauss_newton' or 'exact' (adds costate-contracted dynamics VHPs to the
    # LQ knot, solver-proxddp.hxx:839-843). Pair 'exact' with
    # non-Gauss-Newton costs (QuadraticResidualCost(gauss_newton=False)) for
    # a fully exact Newton step.
    hessian_approx: str = "gauss_newton"
    dphi_thresh: float = 1e-13
    # rollout type: 'linear' (accelerator-friendly, parallel-solver
    # compatible) or 'nonlinear' (reference default)
    rollout: str = "linear"
    # Newton iterations for implicit dynamics inside the nonlinear rollout
    # (reference SolverProxDDP::rollout_max_iters, default 1 —
    # solver-proxddp.hxx:84,411; forwardDynamics::run, utils/forward-dyn.hpp:29).
    # Raise for stiff implicit integrators (e.g. IntegratorMidpoint).
    rollout_max_iters: int = 1
    # LQ subproblem solver (reference LQSolverChoice): 'serial' (scan, with
    # automatic dispatch to the fused Triton kernel under an outer vmap
    # when eligible, gar.riccati.use_fused_kernel), 'serial_scan' (force
    # the XLA scan path), 'parallel' (parallel-in-time leg condensation;
    # requires linear rollout; non-divisible horizons use the balanced
    # get_work split), or 'associative' (O(log N)-depth associative-scan
    # Riccati — latency-optimal for one long horizon; explicit dynamics
    # only; fp32 requires mu >= ~1e-3: the penalty-folded element algebra
    # stops contracting below that — see gar/associative.py)
    linear_solver: str = "serial"
    # XLA-scan Riccati tuning: unroll k stages per scan step. The bf16
    # value-propagation ablation lives on gar.riccati.backward/sweep
    # (bf16_prop=) as a bench-only knob: it costs about two orders of
    # magnitude of dual residual, and the precision policy keeps
    # KKT-adjacent algebra in fp32, so it is deliberately NOT exposed on
    # the production solver config.
    lq_scan_unroll: int = 1
    # runtime μ floor for 'associative': when min(mudyn, mueq) drops below
    # this, the Newton step falls back to the serial sweep for that solve
    # (lax.cond) instead of silently entering the scan's divergence region.
    # None = dtype default (1e-3 fp32, 1e-7 fp64 — the measured domains in
    # gar/associative.py).
    associative_mu_floor: Optional[float] = None
    parallel_legs: int = 2
    force_initial_condition: bool = True
    # record per-iteration convergence traces (HistoryCallback equivalent,
    # reference core/history-callback.hpp:14)
    record_history: bool = False
    # additionally record full xs/us iterate traces per iteration (reference
    # HistoryCallback with store_primal=true, core/history-callback.hpp:36-47)
    record_history_trajs: bool = False
    # in-jit observability (reference Logger rows, utils/logger.hpp:22-28,
    # driven per inner iteration solver-proxddp.hxx:708-721, and the callback
    # registry solver-proxddp.hpp:281-309): verbose=True prints a columnar
    # trace row per iteration via ``jax.debug.callback`` (works inside jit;
    # under vmap one row per batch element). ``callback`` is a host Python
    # callable receiving a dict of scalar traces per iteration.
    verbose: bool = False
    callback: Optional[Callable[[dict], None]] = None
    # initial BCL tolerances
    inner_tol0: float = 1.0
    prim_tol0: float = 1.0

    @property
    def target_dual_tol(self) -> float:
        return self.tol if self.dual_tol is None else self.dual_tol


@pytree_dataclass
class ProxDDPResults:
    """Solver results (reference ``solvers/proxddp/results.hpp``)."""

    xs: jax.Array  # (N+1, nx)
    us: jax.Array  # (N, nu)
    vs: jax.Array  # (N, nc)
    vs_term: jax.Array  # (nc_term,)
    lams: jax.Array  # (N+1, ndx)
    conv: jax.Array  # bool
    num_iters: jax.Array
    al_iter: jax.Array
    prim_infeas: jax.Array
    dual_infeas: jax.Array
    traj_cost: jax.Array
    merit_value: jax.Array
    # control feedback gains of the last LQ solve (for MPC)
    K: Optional[jax.Array] = None  # (N, nu, ndx)
    kff: Optional[jax.Array] = None  # (N, nu)
    # per-iteration traces
    # [prim, dual, inner_crit, cost, merit, mu, al_iter, alpha]
    history: Optional[jax.Array] = None  # (max_iters, 8)
    # full iterate traces (record_history_trajs); vs/lams match the
    # reference HistoryCallback's store of multiplier iterates
    # (core/history-callback.hpp:29 stores lams)
    history_xs: Optional[jax.Array] = None  # (max_iters, N+1, nx)
    history_us: Optional[jax.Array] = None  # (max_iters, N, nu)
    history_vs: Optional[jax.Array] = None  # (max_iters, N, nc)
    history_lams: Optional[jax.Array] = None  # (max_iters, N+1, ndx)
    # final AL penalty (needed to re-assemble the last LQ subproblem, e.g.
    # for θ sensitivities — solvers/sensitivity.py)
    mu_final: Optional[jax.Array] = None  # scalar
    # value-function parameter sensitivities dV/dθ, d²V/dθ² — populated by
    # solvers.theta_sensitivities / solve_with_sensitivities (reference
    # RiccatiSolverBase::thGrad/thHess, gar/riccati-base.hpp:26-34)
    th_grad: Optional[jax.Array] = None  # (nth,)
    th_hess: Optional[jax.Array] = None  # (nth, nth)


@pytree_dataclass
class _State:
    xs: jax.Array
    us: jax.Array
    vs: jax.Array
    vs_term: jax.Array
    lams: jax.Array
    prev_vs: jax.Array
    prev_vs_term: jax.Array
    prev_lams: jax.Array
    mu: jax.Array
    preg: jax.Array
    preg_last: jax.Array
    inner_tol: jax.Array
    prim_tol: jax.Array
    iter: jax.Array
    al_iter: jax.Array
    merit: jax.Array
    cost: jax.Array
    prim_infeas: jax.Array
    dual_infeas: jax.Array
    inner_crit: jax.Array
    conv: jax.Array
    fail: jax.Array
    ls_mov_avg: jax.Array
    ls_avg_weight: jax.Array
    filter_vals: jax.Array  # (F, 2) (merit, infeas) pairs
    filter_valid: jax.Array  # (F,) bool
    K: jax.Array
    kff: jax.Array
    alpha_last: jax.Array  # accepted step length of the last Newton step
    dphi_last: jax.Array  # merit directional derivative of the last step
    history: jax.Array  # (max_iters, 8) or (0, 8)
    hist_xs: jax.Array  # (max_iters, N+1, nx) or (0, ...)
    hist_us: jax.Array  # (max_iters, N, nu) or (0, ...)
    hist_vs: jax.Array  # (max_iters, N, nc) or (0, ...)
    hist_lams: jax.Array  # (max_iters, N+1, ndx) or (0, ...)


def _infnorm(a):
    return jnp.max(jnp.abs(a)) if a.size else jnp.asarray(0.0, a.dtype)


# ---------------------------------------------------------------------------
# Multiplier estimates, merit, Lagrangian gradients
# ---------------------------------------------------------------------------


def _compute_multipliers(problem, cfg, data: ProblemData, state, lams, vs, vs_term):
    """First-order multiplier estimates and AL residuals
    (reference ``computeMultipliers``, solver-proxddp.hxx:210)."""
    mu = state.mu
    mudyn = cfg.dyn_al_scale * mu

    # dynamics / initial constraint ("equality" sets)
    dyn_vals = jnp.concatenate([data.init_res[None], data.dyn_res], axis=0)
    lams_plus = state.prev_lams + dyn_vals / mudyn
    lams_pdal = 2.0 * lams_plus - lams
    Lds = mudyn * (lams_plus - lams)
    dyn_slacks = dyn_vals  # (N+1, ndx)

    # Stacked stage constraint sets: array leaves (e.g. box bounds) carry a
    # leading time axis and broadcast elementwise against (N, nc) inputs.
    cset = problem.stages.constraint_set().set_prox_parameter(mu)
    shifted = data.cstr_vals + mu * state.prev_vs  # (N, nc)
    vs_plus_raw = cset.normal_cone_projection(shifted)
    active = cset.active_mask(shifted)
    Lvs = vs_plus_raw - mu * vs
    vs_plus = vs_plus_raw / mu
    vs_pdal = 2.0 * vs_plus - vs

    tset = problem.term_constraint_set().set_prox_parameter(mu)
    shifted_t = data.term_cstr_vals + mu * state.prev_vs_term
    vs_plus_t_raw = tset.normal_cone_projection(shifted_t)
    active_t = tset.active_mask(shifted_t)
    Lvs_t = vs_plus_t_raw - mu * vs_term
    vs_plus_t = vs_plus_t_raw / mu
    vs_pdal_t = 2.0 * vs_plus_t - vs_term

    if cfg.force_initial_condition:
        Lds = Lds.at[0].set(0.0)

    return dict(
        lams_plus=lams_plus,
        lams_pdal=lams_pdal,
        Lds=Lds,
        dyn_slacks=dyn_slacks,
        shifted=shifted,
        active=active,
        vs_plus=vs_plus,
        vs_pdal=vs_pdal,
        Lvs=Lvs,
        shifted_t=shifted_t,
        active_t=active_t,
        vs_plus_t=vs_plus_t,
        vs_pdal_t=vs_pdal_t,
        Lvs_t=Lvs_t,
    )


def _merit_value(cfg, mu, cost, m):
    """PDAL merit (reference merit-function.hxx:31)."""
    mudyn = cfg.dyn_al_scale * mu
    pen = 0.5 * mudyn * jnp.sum(m["lams_plus"] ** 2)
    pen = pen + 0.5 * mu * jnp.sum(m["vs_plus"] ** 2)
    pen = pen + 0.5 * mu * jnp.sum(m["vs_plus_t"] ** 2)
    return cost + pen


def _lagrangian_grads(problem, cfg, data: ProblemData, lams, vs, vs_term):
    """∇x, ∇u of the problem Lagrangian (reference core/lagrangian.hpp:26)."""
    N = problem.nsteps
    Lxs = jnp.zeros_like(data.Lx)
    Lxs = Lxs.at[0].add(data.init_Jx.T @ lams[0])
    Lxs = Lxs.at[:N].add(
        data.Lx[:N]
        + jnp.einsum("tji,tj->ti", data.A, lams[1:])
        + jnp.einsum("tji,tj->ti", data.cstr_Jx, vs)
    )
    Lxs = Lxs.at[1:].add(jnp.einsum("tji,tj->ti", data.E, lams[1:]))
    Lxs = Lxs.at[N].add(data.Lx[N] + data.term_cstr_Jx.T @ vs_term)
    Lus = (
        data.Lu
        + jnp.einsum("tji,tj->ti", data.B, lams[1:])
        + jnp.einsum("tji,tj->ti", data.cstr_Ju, vs)
    )
    if cfg.force_initial_condition:
        Lxs = Lxs.at[0].set(0.0)
    return Lxs, Lus


def _criteria(cfg, state, m, Lxs, Lus):
    """Infeasibilities + inner criterion (reference
    computeInfeasibilities/computeCriterion, solver-proxddp.hxx:737-794)."""
    mu = state.mu
    stage_infeas = jnp.maximum(
        _infnorm(mu * (m["vs_plus"] - state.prev_vs)),
        _infnorm(mu * (m["vs_plus_t"] - state.prev_vs_term)),
    )
    prim_infeas = jnp.maximum(stage_infeas, _infnorm(m["dyn_slacks"]))
    dual_infeas = jnp.maximum(_infnorm(Lxs), _infnorm(Lus))
    inner_crit = jnp.max(
        jnp.array(
            [
                _infnorm(Lxs),
                _infnorm(Lus),
                _infnorm(m["Lds"]),
                _infnorm(m["Lvs"]),
                _infnorm(m["Lvs_t"]),
            ]
        )
    )
    return prim_infeas, dual_infeas, inner_crit


# ---------------------------------------------------------------------------
# LQ subproblem assembly
# ---------------------------------------------------------------------------


def _assemble_lq(problem, cfg, data, m, Lxs, Lus, preg, mu):
    """Fill the proximal LQ subproblem from stage data (reference
    ``updateLQSubproblem``, solver-proxddp.hxx:802) with active-set
    projected constraint Jacobians (``computeProjectedJacobians``,
    solver-proxddp.hxx:22-67)."""
    N = problem.nsteps
    ndx, nu = problem.space.ndx, problem.nu
    nc, nct = problem.nc, problem.nc_term
    ncmax = max(nc, nct)
    dt = data.Lx.dtype
    T = N + 1
    eye_x = jnp.eye(ndx, dtype=dt)
    eye_u = jnp.eye(nu, dtype=dt)

    act = m["active"][..., None]
    Cp = jnp.where(act, data.cstr_Jx, 0.0)  # (N, nc, ndx)
    Dp = jnp.where(act, data.cstr_Ju, 0.0)
    act_t = m["active_t"][..., None]
    Cp_t = jnp.where(act_t, data.term_cstr_Jx, 0.0)  # (nct, ndx)

    Lv_s = m["Lvs"] / mu  # (N, nc)
    corr_x = jnp.einsum("tji,tj->ti", data.cstr_Jx - Cp, Lv_s)  # (N, ndx)
    corr_u = jnp.einsum("tji,tj->ti", data.cstr_Ju - Dp, Lv_s)
    Lv_ts = m["Lvs_t"] / mu
    corr_xt = (data.term_cstr_Jx - Cp_t).T @ Lv_ts  # (ndx,)

    Q = data.Lxx + preg * eye_x  # (N+1, ndx, ndx)
    q = Lxs + jnp.concatenate([corr_x, corr_xt[None]], axis=0)

    Lxu, Luu = data.Lxu, data.Luu
    if data.Hxx is not None:
        # exact-Hessian mode: add costate-contracted dynamics VHPs
        # (reference solver-proxddp.hxx:839-843)
        Q = Q.at[:N].add(data.Hxx)
        Lxu = Lxu + data.Hxu
        Luu = Luu + data.Huu
    S = jnp.concatenate([Lxu, jnp.zeros((1, ndx, nu), dt)], axis=0)
    R = jnp.concatenate([Luu + preg * eye_u, eye_u[None]], axis=0)
    r = jnp.concatenate([Lus + corr_u, jnp.zeros((1, nu), dt)], axis=0)

    zx = jnp.zeros((1, ndx, ndx), dt)
    A = jnp.concatenate([data.A, zx], axis=0)
    B = jnp.concatenate([data.B, jnp.zeros((1, ndx, nu), dt)], axis=0)
    E = jnp.concatenate([data.E, zx], axis=0)
    f = jnp.concatenate([m["Lds"][1:], jnp.zeros((1, ndx), dt)], axis=0)

    C = jnp.zeros((T, ncmax, ndx), dt)
    D = jnp.zeros((T, ncmax, nu), dt)
    d = jnp.zeros((T, ncmax), dt)
    if nc > 0:
        C = C.at[:N, :nc].set(Cp)
        D = D.at[:N, :nc].set(Dp)
        d = d.at[:N, :nc].set(m["Lvs"])
    if nct > 0:
        C = C.at[N, :nct].set(Cp_t)
        d = d.at[N, :nct].set(m["Lvs_t"])

    knots = lqr_mod.LQRKnots(
        Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, E=E, f=f, C=C, D=D, d=d
    )
    g0 = m["Lds"][0]
    if cfg.force_initial_condition:
        g0 = jnp.zeros_like(g0)
    return lqr_mod.LQRProblem(knots=knots, G0=data.init_Jx, g0=g0)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _linear_step(problem, state, steps, alpha):
    """Trial point from a linear step (reference tryLinearStep,
    solver-proxddp.hxx:104)."""
    space = problem.space
    dxs, dus, dvs, dvs_t, dlams = steps
    trial_xs = jax.vmap(lambda x, dx: space.integrate(x, alpha * dx))(
        state.xs, dxs
    )
    trial_us = state.us + alpha * dus
    trial_vs = state.vs + alpha * dvs
    trial_vs_t = state.vs_term + alpha * dvs_t
    trial_lams = state.lams + alpha * dlams
    return trial_xs, trial_us, trial_vs, trial_vs_t, trial_lams, None


def _nonlinear_rollout(problem, cfg, state, factors, steps, alpha, mu):
    """Trial point from a closed-loop nonlinear rollout (reference
    tryNonlinearRollout, solver-proxddp.hxx:339)."""
    space = problem.space
    N = problem.nsteps
    nc = problem.nc
    mudyn = cfg.dyn_al_scale * mu
    dxs, dus, dvs, dvs_t, dlams = steps

    dx0 = alpha * dxs[0]
    x0_trial = space.integrate(state.xs[0], dx0)
    lam0_trial = state.lams[0] + alpha * dlams[0]

    def body(carry, inp):
        x_tr, dx = carry
        stage, kff, K, zff, Z, lff, L, x_cur, x_next, u_cur, v_cur, lam_next, prev_lam_next = inp
        du = alpha * kff + K @ dx
        u_tr = u_cur + du
        dv = alpha * zff[:nc] + Z[:nc] @ dx
        v_tr = v_cur + dv
        dlam = alpha * lff + L @ dx
        lam_tr = lam_next + dlam
        slack = mudyn * (prev_lam_next - lam_tr)
        if stage.dynamics.is_explicit:
            xpred = stage.dynamics.forward(space, x_tr, u_tr)
            x_next_tr = space.integrate(xpred, slack)
        else:
            # implicit dynamics: Newton-solve r(x,u,y) + slack = 0 in-loop
            # (reference forwardDynamics::run, utils/forward-dyn.hpp:38-55)
            x_next_tr = stage.dynamics.forward_with_gap(
                space, x_tr, u_tr, slack, iters=cfg.rollout_max_iters
            )
        dx_next = space.difference(x_next, x_next_tr)
        return (x_next_tr, dx_next), dict(
            x=x_tr, u=u_tr, v=v_tr, lam=lam_tr, slack=slack
        )

    inps = (
        problem.stages,
        factors.kff[:N],
        factors.K[:N],
        factors.zff[:N],
        factors.Z[:N],
        factors.lff[:N],
        factors.L[:N],
        state.xs[:N],
        state.xs[1:],
        state.us,
        state.vs,
        state.lams[1:],
        state.prev_lams[1:],
    )
    (xN_tr, dxN), outs = lax.scan(body, (x0_trial, dx0), inps)

    nct = problem.nc_term
    dv_t = alpha * factors.zff[N][:nct] + factors.Z[N][:nct] @ dxN
    trial_vs_t = state.vs_term + dv_t

    trial_xs = jnp.concatenate([outs["x"], xN_tr[None]], axis=0)
    trial_lams = jnp.concatenate([lam0_trial[None], outs["lam"]], axis=0)
    return trial_xs, outs["u"], outs["v"], trial_vs_t, trial_lams, outs["slack"]


def _forward_pass(problem, cfg, state, factors, steps, alpha, mu):
    """Trial point + its evaluation + multipliers + merit
    (reference forwardPass, solver-proxddp.hxx:579)."""
    if cfg.rollout == "linear":
        txs, tus, tvs, tvt, tlams, _ = _linear_step(problem, state, steps, alpha)
        data = problem_mod.evaluate(problem, txs, tus)
    else:
        txs, tus, tvs, tvt, tlams, slacks = _nonlinear_rollout(
            problem, cfg, state, factors, steps, alpha, mu
        )
        data = problem_mod.evaluate(problem, txs, tus)
        # by construction the rollout's dynamics gap equals -slack
        data = replace(data, dyn_res=-slacks)
    m = _compute_multipliers(problem, cfg, data, state, tlams, tvs, tvt)
    phi = _merit_value(cfg, mu, data.cost, m)
    stage_infeas = jnp.maximum(
        _infnorm(mu * (m["vs_plus"] - state.prev_vs)),
        _infnorm(mu * (m["vs_plus_t"] - state.prev_vs_term)),
    )
    prim = jnp.maximum(stage_infeas, _infnorm(m["dyn_slacks"]))
    return (txs, tus, tvs, tvt, tlams), data.cost, phi, prim


# ---------------------------------------------------------------------------
# Main solve loop
# ---------------------------------------------------------------------------


def solve(
    problem: TrajOptProblem,
    cfg: ProxDDPConfig = ProxDDPConfig(),
    xs_init: Optional[jax.Array] = None,
    us_init: Optional[jax.Array] = None,
    vs_init: Optional[jax.Array] = None,
    lams_init: Optional[jax.Array] = None,
) -> ProxDDPResults:
    """Run ProxDDP. jit/vmap-compatible; fixed iteration bounds.

    Control flow mirrors ``SolverProxDDPTpl::run`` (solver-proxddp.hxx:458)
    with the inner loop flattened (see module docstring)."""
    space = problem.space
    N = problem.nsteps
    ndx, nu, nc, nct = space.ndx, problem.nu, problem.nc, problem.nc_term

    if problem.init_constraint is not None and cfg.force_initial_condition:
        raise ValueError(
            "a general init_constraint requires "
            "ProxDDPConfig(force_initial_condition=False) "
            "(reference: solver.force_initial_condition = False in "
            "examples/partial_initial_condition.py)"
        )

    dtype = problem.x0.dtype
    if xs_init is None:
        xs_init = jnp.broadcast_to(problem.x0, (N + 1,) + problem.x0.shape)
    if us_init is None:
        us_init = jnp.zeros((N, nu), dtype)
    if vs_init is None:
        vs_init = jnp.zeros((N, nc), dtype)
    lams0 = jnp.zeros((N + 1, ndx), dtype) if lams_init is None else lams_init
    vs_term0 = jnp.zeros((nct,), dtype)

    mu0 = jnp.asarray(max(cfg.mu_init, cfg.mu_lower_bound), dtype)
    arg0 = jnp.minimum(mu0, 0.99)
    inner_tol = jnp.maximum(
        cfg.inner_tol0 * arg0**cfg.dual_alpha, cfg.target_dual_tol
    )
    prim_tol = jnp.maximum(cfg.prim_tol0 * arg0**cfg.prim_alpha, cfg.tol)

    # E = -I fast path: valid only for explicit dynamics on a vector space
    # (implicit integrators produce general E blocks).
    assume_explicit = isinstance(space, VectorSpace) and getattr(
        problem.stages.dynamics, "is_explicit", True
    )

    st = _State(
        xs=xs_init,
        us=us_init,
        vs=vs_init,
        vs_term=vs_term0,
        lams=lams0,
        prev_vs=vs_init,
        prev_vs_term=vs_term0,
        prev_lams=lams0,
        mu=mu0,
        preg=jnp.asarray(max(cfg.reg_init, cfg.reg_min), dtype),
        preg_last=jnp.asarray(0.0, dtype),
        inner_tol=inner_tol,
        prim_tol=prim_tol,
        iter=jnp.asarray(0, jnp.int32),
        al_iter=jnp.asarray(0, jnp.int32),
        merit=jnp.asarray(jnp.inf, dtype),
        cost=jnp.asarray(jnp.inf, dtype),
        prim_infeas=jnp.asarray(jnp.inf, dtype),
        dual_infeas=jnp.asarray(jnp.inf, dtype),
        inner_crit=jnp.asarray(jnp.inf, dtype),
        conv=jnp.asarray(False),
        fail=jnp.asarray(False),
        ls_mov_avg=jnp.asarray(0.0, dtype),
        ls_avg_weight=jnp.asarray(0.0, dtype),
        filter_vals=jnp.zeros((cfg.filter_size, 2), dtype),
        filter_valid=jnp.zeros((cfg.filter_size,), bool),
        alpha_last=jnp.asarray(0.0, dtype),
        dphi_last=jnp.asarray(0.0, dtype),
        history=jnp.zeros(
            (cfg.max_iters if cfg.record_history else 0, 8), dtype
        ),
        hist_xs=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N + 1)
            + problem.x0.shape,
            dtype,
        ),
        hist_us=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N, nu), dtype
        ),
        hist_vs=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N, nc), dtype
        ),
        hist_lams=jnp.zeros(
            (cfg.max_iters if cfg.record_history_trajs else 0, N + 1, ndx),
            dtype,
        ),
        K=jnp.zeros((N + 1, nu, ndx), dtype),
        kff=jnp.zeros((N + 1, nu), dtype),
    )

    def bcl_update(st: _State, m, inner_done):
        """BCL outer update (reference run() loop body,
        solver-proxddp.hxx:519-570)."""
        prim_ok = st.prim_infeas <= st.prim_tol

        # success branch: tighten tolerances until inner_tol <= inner_crit
        arg = jnp.minimum(st.mu, 0.99)

        def tighten(tols):
            pt, it = tols
            return pt * arg**cfg.prim_beta, it * arg**cfg.dual_beta

        def tighten_loop(tols):
            pt, it = lax.while_loop(
                lambda tols: st.inner_crit < tols[1],
                lambda tols: tighten(tols),
                tighten(tols),
            )
            return pt, it

        pt_s, it_s = tighten_loop((st.prim_tol, st.inner_tol))
        # multiplier update mode (reference run():535-550)
        if cfg.multiplier_update_mode == "newton":
            prev_vs_s, prev_vt_s, prev_lams_s = st.vs, st.vs_term, st.lams
        elif cfg.multiplier_update_mode == "primal":
            prev_vs_s = m["vs_plus"]
            prev_vt_s = m["vs_plus_t"]
            prev_lams_s = m["lams_plus"]
        elif cfg.multiplier_update_mode == "primal_dual":
            prev_vs_s = m["vs_pdal"]
            prev_vt_s = m["vs_pdal_t"]
            prev_lams_s = m["lams_pdal"]
        else:
            raise ValueError(cfg.multiplier_update_mode)

        # failure branch: increase penalty, loosen tolerances
        mu_f = jnp.maximum(st.mu * cfg.mu_update_factor, cfg.mu_lower_bound)
        # reset to mu_init when the floor is hit (solver-proxddp.hxx:560-563)
        mu_f = jnp.where(
            mu_f <= cfg.mu_lower_bound * (1.0 + 1e-12),
            jnp.asarray(max(cfg.mu_init, cfg.mu_lower_bound), mu_f.dtype),
            mu_f,
        )
        arg_f = jnp.minimum(mu_f, 0.99)
        pt_f = cfg.prim_tol0 * arg_f**cfg.prim_alpha
        it_f = cfg.inner_tol0 * arg_f**cfg.dual_alpha

        new_mu = jnp.where(prim_ok, st.mu, mu_f)
        new_pt = jnp.where(prim_ok, pt_s, pt_f)
        new_it = jnp.where(prim_ok, it_s, it_f)
        new_prev_vs = jnp.where(prim_ok, prev_vs_s, st.prev_vs)
        new_prev_vt = jnp.where(prim_ok, prev_vt_s, st.prev_vs_term)
        new_prev_lams = jnp.where(prim_ok, prev_lams_s, st.prev_lams)

        conv = jnp.logical_and(
            prim_ok,
            jnp.logical_and(
                st.dual_infeas <= cfg.target_dual_tol, st.prim_infeas <= cfg.tol
            ),
        )

        # clamp (solver-proxddp.hxx:566)
        new_it = jnp.maximum(new_it, 0.01 * cfg.target_dual_tol)
        new_pt = jnp.maximum(new_pt, cfg.tol)

        def apply(st):
            return replace(
                st,
                mu=new_mu,
                prim_tol=new_pt,
                inner_tol=new_it,
                prev_vs=new_prev_vs,
                prev_vs_term=new_prev_vt,
                prev_lams=new_prev_lams,
                al_iter=st.al_iter + 1,
                conv=jnp.logical_or(st.conv, conv),
                # linesearch_.reset() on inner-loop success (run():524)
                ls_mov_avg=jnp.zeros_like(st.ls_mov_avg),
                ls_avg_weight=jnp.zeros_like(st.ls_avg_weight),
            )

        return jax.tree.map(
            lambda a, b: jnp.where(inner_done, a, b), apply(st), st
        )

    def newton_step(st: _State):
        # initializeRegularization (solver-proxddp.hpp:351): attempt a
        # decrease from the last good value.
        preg0 = jnp.where(
            st.preg_last == 0.0,
            jnp.asarray(max(cfg.reg_init, cfg.reg_min), dtype),
            jnp.maximum(cfg.reg_min, st.preg_last * cfg.reg_dec_k),
        )
        st = replace(st, preg=preg0)
        vhp_lams = st.lams if cfg.hessian_approx == "exact" else None
        data = problem_mod.compute_derivatives(
            problem, st.xs, st.us, lams=vhp_lams
        )
        m = _compute_multipliers(
            problem, cfg, data, st, st.lams, st.vs, st.vs_term
        )
        phi0 = _merit_value(cfg, st.mu, data.cost, m)
        Lxs, Lus = _lagrangian_grads(
            problem, cfg, data, st.lams, st.vs, st.vs_term
        )

        mudyn = cfg.dyn_al_scale * st.mu
        lq = _assemble_lq(problem, cfg, data, m, Lxs, Lus, st.preg, st.mu)
        if cfg.linear_solver == "parallel":
            # parallel-in-time leg condensation (reference requires LINEAR
            # rollout with the parallel solver, solver-proxddp.hxx:169-181)
            if cfg.rollout != "linear":
                raise ValueError(
                    "parallel linear solver requires rollout='linear'"
                )
            dxs, dus_p, dvs_p, dlams, pgains = gar_parallel.solve(
                lq, mudyn, st.mu, cfg.parallel_legs, assume_explicit,
                return_gains=True,
            )
            factors = None
            gain_K, gain_kff = pgains.K, pgains.kff
        elif cfg.linear_solver == "associative":
            # O(log N)-depth parallel-in-time solve (gar/associative.py):
            # the latency-optimal choice for ONE long-horizon problem
            if not assume_explicit:
                raise ValueError(
                    "associative linear solver requires explicit dynamics "
                    "on a vector space"
                )
            # μ-domain guard (gar/associative.py conditioning note): below
            # the dtype floor the penalty-folded element algebra stops
            # contracting and refinement diverges; fall back to the serial
            # sweep per solve at runtime so BCL μ-tightening stays safe.
            floor = cfg.associative_mu_floor
            if floor is None:
                floor = 1e-3 if dtype == jnp.float32 else 1e-7

            def _assoc_solve(lq_):
                return gar_associative.solve(
                    lq_, mudyn, st.mu, return_gains=True, refine_steps=1
                )

            def _serial_solve(lq_):
                f = riccati.backward(lq_, mudyn, st.mu, assume_explicit)
                out = riccati.forward(f)
                return (*out, f)

            mu_ok = jnp.minimum(mudyn, st.mu) >= floor
            dxs, dus_p, dvs_p, dlams, factors = jax.lax.cond(
                mu_ok, _assoc_solve, _serial_solve, lq
            )
            gain_K, gain_kff = factors.K, factors.kff
        elif (
            cfg.linear_solver == "serial"
            and lq.nth == 0
            and lq.nc0 == lq.nx
        ):
            # serial solve through the custom_vmap dispatcher: unbatched it
            # is the same backward+forward scan; under an outer vmap (the
            # batched-MPC execution model) the whole batch goes to the fused
            # Triton kernel when eligible (gar/pallas_riccati.py)
            dxs, dus_p, dvs_p, dlams, gains = riccati.solve_and_gains(
                lq, mudyn, st.mu, assume_explicit,
                unroll=cfg.lq_scan_unroll,
            )
            factors = riccati.RiccatiFactors(
                **gains,
                Pmat=jnp.zeros_like(gains["Afb"]),
                pvec=jnp.zeros_like(gains["yff"]),
                x0=dxs[0],
                lam0=dlams[0],
            )
            gain_K, gain_kff = factors.K, factors.kff
        else:
            factors = riccati.backward(
                lq, mudyn, st.mu, assume_explicit,
                unroll=cfg.lq_scan_unroll,
            )
            dxs, dus_p, dvs_p, dlams = riccati.forward(
                factors, unroll=cfg.lq_scan_unroll
            )
            gain_K, gain_kff = factors.K, factors.kff
        dus = dus_p[:N]
        dvs = dvs_p[:N, :nc]
        dvs_t = dvs_p[N, :nct]
        if cfg.force_initial_condition:
            dxs = dxs.at[0].set(0.0)
            dlams = dlams.at[0].set(0.0)
        steps = (dxs, dus, dvs, dvs_t, dlams)

        # directional derivative with first-order multiplier estimates
        # (reference PDALFunction::directionalDerivative, merit-function.hxx:65)
        Lxs_p, Lus_p = _lagrangian_grads(
            problem, cfg, data, m["lams_plus"], m["vs_plus"], m["vs_plus_t"]
        )
        dphi0 = jnp.sum(Lxs_p * dxs) + jnp.sum(Lus_p * dus)

        # --- step acceptance: backtracking on merit / filter ---
        def try_alpha(alpha):
            return _forward_pass(problem, cfg, st, factors, steps, alpha, st.mu)

        # Nonmonotone (Zhang-Hager 2004) moving-average reference value
        # (reference core/linesearch-nonmonotone.hpp:42-46); with
        # ls_strategy='armijo' the reference value is just phi0.
        if cfg.ls_strategy == "nonmonotone":
            mov_avg = (
                cfg.ls_avg_eta * st.ls_avg_weight * st.ls_mov_avg + phi0
            )
            avg_weight = cfg.ls_avg_eta * st.ls_avg_weight + 1.0
            mov_avg = mov_avg / avg_weight
            phi_ref = mov_avg
            st = replace(st, ls_mov_avg=mov_avg, ls_avg_weight=avg_weight)
        else:
            phi_ref = phi0

        trial1, cost1, phi1, prim1 = try_alpha(jnp.asarray(1.0, dtype))

        if cfg.ls_strategy == "filter":
            # merit/infeasibility dominance filter (reference
            # core/filter.hpp:42-105): a pair is rejected if some filter
            # element dominates it (with proximity margin beta).
            def accepted(phi, prim):
                dominated = jnp.logical_and(
                    st.filter_vals[:, 0] + cfg.filter_beta * st.filter_vals[:, 1]
                    <= phi,
                    st.filter_vals[:, 1] + cfg.filter_beta * st.filter_vals[:, 1]
                    <= prim,
                )
                bad = jnp.any(jnp.logical_and(dominated, st.filter_valid))
                return jnp.logical_and(jnp.isfinite(phi), jnp.logical_not(bad))

            def ls_cond(carry):
                k, alpha, trial, cost, phi, prim = carry
                return jnp.logical_and(
                    jnp.logical_and(
                        jnp.logical_not(accepted(phi, prim)),
                        k < cfg.ls_max_steps,
                    ),
                    alpha > cfg.ls_alpha_min,
                )

            def ls_body(carry):
                k, alpha, trial, cost, phi, prim = carry
                alpha2 = jnp.maximum(
                    alpha * cfg.ls_contraction, cfg.ls_alpha_min
                )
                trial2, cost2, phi2, prim2 = try_alpha(alpha2)
                return (k + 1, alpha2, trial2, cost2, phi2, prim2)

            k, alpha, trial, cost, phi, prim_t = lax.while_loop(
                ls_cond,
                ls_body,
                (jnp.asarray(0, jnp.int32), jnp.asarray(1.0, dtype), trial1, cost1, phi1, prim1),
            )
            # update filter: drop entries dominated by the new pair, insert it
            dominated_by_new = jnp.logical_and(
                phi <= st.filter_vals[:, 0], prim_t <= st.filter_vals[:, 1]
            )
            valid = jnp.logical_and(
                st.filter_valid, jnp.logical_not(dominated_by_new)
            )
            # first free slot; when the pool is full, evict the entry with
            # the largest merit (the point of the filter is its lower
            # envelope — the max-φ entry is the least binding). The
            # reference's vector append (core/filter.hpp:42-105) is
            # unbounded; a fixed pool needs an explicit eviction policy.
            free_slot = jnp.argmin(valid)
            evict_slot = jnp.argmax(
                jnp.where(valid, st.filter_vals[:, 0], -jnp.inf)
            )
            slot = jnp.where(jnp.all(valid), evict_slot, free_slot)
            fvals = st.filter_vals.at[slot].set(jnp.stack([phi, prim_t]))
            fvalid = valid.at[slot].set(True)
            st = replace(st, filter_vals=fvals, filter_valid=fvalid)
        else:

            def _interp_alpha(k, alpha, phi_a, alpha_p, phi_p):
                """Safeguarded polynomial step proposal (reference
                minimize_interpolant, linesearch-armijo.hpp:150-210):
                quadratic from (φ(0), φ'(0), φ(α)); cubic additionally uses
                the previous sample (α_p, φ(α_p)); the minimizer is clamped
                to [c_min·α, c_max·α]."""
                if cfg.ls_interp == "bisection":
                    return alpha * cfg.ls_contraction
                # quadratic model: φ0 + dφ0·a + qa·a²
                qa = (phi1_safe(phi_a) - phi0 - alpha * dphi0) / (alpha * alpha)
                cand_quad = -dphi0 / (2.0 * qa)
                cand = cand_quad
                if cfg.ls_interp == "cubic":
                    # cubic model through (α, φ_a) and (α_p, φ_p):
                    # c3 a³ + c2 a² + dφ0 a + φ0, coefficients by Cramer on
                    # [[a0³,a0²],[a1³,a1²]][c3,c2] = [r(a0), r(a1)]
                    a0, a1 = alpha, alpha_p
                    r0 = phi1_safe(phi_a) - phi0 - dphi0 * a0
                    r1 = phi1_safe(phi_p) - phi0 - dphi0 * a1
                    det = a0 * a0 * a1 * a1 * (a0 - a1)
                    c3 = (r0 * a1 * a1 - a0 * a0 * r1) / det
                    c2 = (a0 * a0 * a0 * r1 - a1 * a1 * a1 * r0) / det
                    disc = c2 * c2 - 3.0 * c3 * dphi0
                    cand_cubic = (-c2 + jnp.sqrt(jnp.maximum(disc, 0.0))) / (
                        3.0 * c3
                    )
                    use_cubic = jnp.logical_and(
                        k >= 1,
                        jnp.logical_and(
                            jnp.isfinite(cand_cubic), jnp.abs(c3) > 1e-30
                        ),
                    )
                    cand = jnp.where(use_cubic, cand_cubic, cand_quad)
                cand = jnp.where(
                    jnp.isfinite(cand), cand, cfg.ls_contraction_min * alpha
                )
                return jnp.clip(
                    cand,
                    cfg.ls_contraction_min * alpha,
                    cfg.ls_contraction_max * alpha,
                )

            def phi1_safe(p):
                # a NaN/Inf merit sample would poison the interpolant; treat
                # it as a very large finite value so the proposal collapses
                # to the lower safeguard (reference backtracks on exception).
                big = jnp.asarray(jnp.finfo(dtype).max / 8, dtype)
                return jnp.where(jnp.isfinite(p), p, big)

            def ls_cond(carry):
                k, alpha, trial, cost, phi, prim, a_prev, phi_prev = carry
                # NaN-safe: a NaN/Inf merit must fail the acceptance test and
                # trigger backtracking (the reference raises + catches,
                # linesearch-armijo.hpp:70-81 / filter.hpp:47-57).
                ok = phi <= phi_ref + cfg.ls_armijo_c1 * alpha * dphi0
                return jnp.logical_and(
                    jnp.logical_and(jnp.logical_not(ok), k < cfg.ls_max_steps),
                    alpha > cfg.ls_alpha_min,
                )

            def ls_body(carry):
                k, alpha, trial, cost, phi, prim, a_prev, phi_prev = carry
                alpha2 = jnp.maximum(
                    _interp_alpha(k, alpha, phi, a_prev, phi_prev),
                    cfg.ls_alpha_min,
                )
                trial2, cost2, phi2, prim2 = try_alpha(alpha2)
                return (k + 1, alpha2, trial2, cost2, phi2, prim2, alpha, phi)

            one = jnp.asarray(1.0, dtype)
            k, alpha, trial, cost, phi, _, _, _ = lax.while_loop(
                ls_cond,
                ls_body,
                (
                    jnp.asarray(0, jnp.int32), one, trial1, cost1, phi1,
                    prim1, one, phi1,
                ),
            )

        # early-stop: with a null directional derivative the step is noise
        # (reference solver-proxddp.hxx:676) — keep the current iterate.
        tiny_dir = jnp.abs(dphi0) <= cfg.dphi_thresh
        # reject a non-finite trial outright: keep the previous iterate and
        # treat as a linesearch failure (escalates regularization below).
        trial_ok = jnp.logical_and(jnp.isfinite(phi), jnp.logical_not(tiny_dir))
        txs, tus, tvs, tvt, tlams = trial
        prev = (st.xs, st.us, st.vs, st.vs_term, st.lams)
        txs, tus, tvs, tvt, tlams = jax.tree.map(
            lambda new, old: jnp.where(trial_ok, new, old),
            (txs, tus, tvs, tvt, tlams),
            prev,
        )
        alpha = jnp.where(trial_ok, alpha, cfg.ls_alpha_min)
        st = replace(
            st,
            xs=txs,
            us=tus,
            vs=tvs,
            vs_term=tvt,
            lams=tlams,
            cost=jnp.where(trial_ok, cost, st.cost),
            merit=jnp.where(trial_ok, phi, st.merit),
            K=gain_K,
            kff=gain_kff,
            alpha_last=alpha,
            dphi_last=dphi0,
        )

        # regularization schedule (solver-proxddp.hpp:349-366): on linesearch
        # failure escalate (increaseRegularization, then ``preg_last_ = preg_``
        # at the end of EVERY inner iteration — solver-proxddp.hxx:726,733 —
        # so escalations persist into the next iteration's
        # initializeRegularization). A tiny-direction early stop is not a
        # failure.
        ls_failed = jnp.logical_and(
            alpha <= cfg.ls_alpha_min, jnp.logical_not(tiny_dir)
        )
        preg_inc = jnp.where(
            st.preg_last == 0.0,
            st.preg * cfg.reg_inc_first_k,
            st.preg * cfg.reg_inc_k,
        )
        fail = jnp.logical_and(ls_failed, st.preg >= cfg.reg_max)
        new_preg = jnp.where(
            ls_failed, jnp.minimum(preg_inc, cfg.reg_max), st.preg
        )
        st = replace(
            st,
            preg=new_preg,
            preg_last=new_preg,
            fail=jnp.logical_or(st.fail, fail),
        )
        return st

    def body(st: _State):
        # evaluate criterion at the current iterate
        data = problem_mod.compute_derivatives(problem, st.xs, st.us)
        m = _compute_multipliers(
            problem, cfg, data, st, st.lams, st.vs, st.vs_term
        )
        Lxs, Lus = _lagrangian_grads(
            problem, cfg, data, st.lams, st.vs, st.vs_term
        )
        prim, dual, crit = _criteria(cfg, st, m, Lxs, Lus)
        st = replace(
            st,
            prim_infeas=prim,
            dual_infeas=dual,
            inner_crit=crit,
            cost=data.cost,
        )
        if cfg.record_history:
            row = jnp.stack(
                [
                    prim, dual, crit, data.cost, st.merit, st.mu,
                    st.al_iter.astype(dtype), st.alpha_last,
                ]
            )
            st = replace(st, history=st.history.at[st.iter].set(row))
        if cfg.verbose or cfg.callback is not None:
            # per-iteration trace row from inside jit (reference logs each
            # inner iteration, solver-proxddp.hxx:708-721, and invokes the
            # registered callbacks, solver-proxddp.hpp:281-309)
            def _emit(it, al, alpha, prim_e, dual_e, crit_e, cost_e, merit_e,
                      mu_e, preg_e, dphi0_e):
                trace = {
                    "iter": int(it) + 1,
                    "al_iter": int(al) + 1,
                    "alpha": float(alpha),
                    "prim_err": float(prim_e),
                    "dual_err": float(dual_e),
                    "inner_crit": float(crit_e),
                    "preg": float(preg_e),
                    "dphi0": float(dphi0_e),
                    "cost": float(cost_e),
                    "merit": float(merit_e),
                    "mu": float(mu_e),
                }
                if cfg.verbose:
                    logger_mod.log_row(trace, header=trace["iter"] == 1)
                if cfg.callback is not None:
                    cfg.callback(trace)

            jax.debug.callback(
                _emit, st.iter, st.al_iter, st.alpha_last, prim, dual, crit,
                data.cost, st.merit, st.mu, st.preg, st.dphi_last,
            )
        if cfg.record_history_trajs:
            st = replace(
                st,
                hist_xs=st.hist_xs.at[st.iter].set(st.xs),
                hist_us=st.hist_us.at[st.iter].set(st.us),
                hist_vs=st.hist_vs.at[st.iter].set(st.vs),
                hist_lams=st.hist_lams.at[st.iter].set(st.lams),
            )

        overall = jnp.logical_and(
            dual <= cfg.target_dual_tol, prim <= cfg.tol
        )
        inner_done = jnp.logical_or(crit <= st.inner_tol, overall)
        st = bcl_update(st, m, inner_done)

        # Newton step unless converged/failed
        active = jnp.logical_not(jnp.logical_or(st.conv, st.fail))
        st = lax.cond(active, newton_step, lambda s: s, st)
        return replace(st, iter=st.iter + 1)

    def cond(st: _State):
        return jnp.logical_and(
            jnp.logical_and(st.iter < cfg.max_iters, jnp.logical_not(st.conv)),
            jnp.logical_and(
                jnp.logical_not(st.fail), st.al_iter < cfg.max_al_iters
            ),
        )

    st = lax.while_loop(cond, body, st)

    # final criterion refresh
    data = problem_mod.compute_derivatives(problem, st.xs, st.us)
    m = _compute_multipliers(problem, cfg, data, st, st.lams, st.vs, st.vs_term)
    Lxs, Lus = _lagrangian_grads(problem, cfg, data, st.lams, st.vs, st.vs_term)
    prim, dual, crit = _criteria(cfg, st, m, Lxs, Lus)
    conv = jnp.logical_or(
        st.conv,
        jnp.logical_and(dual <= cfg.target_dual_tol, prim <= cfg.tol),
    )

    return ProxDDPResults(
        xs=st.xs,
        us=st.us,
        vs=st.vs,
        vs_term=st.vs_term,
        lams=st.lams,
        conv=conv,
        num_iters=st.iter,
        al_iter=st.al_iter,
        prim_infeas=prim,
        dual_infeas=dual,
        traj_cost=data.cost,
        merit_value=st.merit,
        K=st.K[: problem.nsteps],
        kff=st.kff[: problem.nsteps],
        history=st.history if cfg.record_history else None,
        history_xs=st.hist_xs if cfg.record_history_trajs else None,
        history_us=st.hist_us if cfg.record_history_trajs else None,
        history_vs=st.hist_vs if cfg.record_history_trajs else None,
        history_lams=st.hist_lams if cfg.record_history_trajs else None,
        mu_final=st.mu,
    )
