"""Serial proximal Riccati solver as a `lax.scan`.

Accelerator-native re-derivation of the reference's stagewise backward recursion for
the dual-regularized LQ problem (``include/aligator/gar/riccati-kernel.hxx``):

* the per-stage reduced KKT ``[[R̂, D'], [D, -μ_eq I]]`` is solved by **Schur
  elimination of the multiplier** — ``(R̂ + D'D/μ_eq) u = ...`` — which is
  symmetric positive definite thanks to the proximal regularization, so a
  Cholesky factorization suffices. This deliberately replaces the reference's
  Bunch-Kaufman with data-*independent* control flow (no pivoting), which is
  what vectorizes over a batch.
* the Schur matrix ``I + μ_dyn·P̃`` trick for implicit dynamics
  ``E x' + A x + B u + f = 0`` is kept; when ``assume_explicit`` is set,
  ``E = -I`` is exploited and the E-factorization is skipped entirely.
* the whole horizon recursion is a single `jax.lax.scan` (reverse), so the
  solver is jit-able, vmap-able over thousands of scenario batches, and
  differentiable.

Parametric-θ blocks (``Gx, Gu, Gth, gamma``) are propagated exactly as in the
reference (``riccati-kernel.hxx:256-299``); they power both the
parallel-in-time leg condensation and MPC sensitivities.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .._precision import highest_precision
from .._pytree import pytree_dataclass
from . import smallmat
from .lqr_problem import LQRKnots, LQRProblem


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def _chol_solve(M, B):
    """Solve M X = B with M SPD (closed form for tiny M, Cholesky else)."""
    return smallmat.solve_spd(M, B)


def _spd_solver(M):
    """Return a solve closure for SPD M, amortizing the factorization:
    tiny M → hand-unrolled scalar Cholesky (fuses in-scan, LAPACK-grade
    accuracy); larger M → cho_factor reused across solves."""
    return smallmat.spd_solver(M)


def spd_solve(M, B):
    """Differentiable SPD solve ``M X = B`` (``smallmat.solve_spd`` inside).

    Callers like the contact-dynamics KKT (``modelling/multibody/contact.py``)
    must stay differentiable in BOTH modes (loop constraints and
    model-parameter tangents differentiate straight through the solve; the
    solver's GN assembly uses jacfwd, the test oracles use jacrev).
    ``lax.custom_linear_solve`` provides the implicit-function JVP *and* the
    transpose rule (symmetric system ⇒ the transpose solve is the same
    solve)."""

    def mv(x):
        if x.ndim == M.ndim:  # matrix RHS
            return M @ x
        return (M @ x[..., None])[..., 0]

    return lax.custom_linear_solve(
        mv, B, solve=lambda _, b: smallmat.solve_spd(M, b),
        symmetric=True,
    )


@pytree_dataclass
class RiccatiFactors:
    """Feedforward/feedback gains and value function per stage.

    Analog of the reference ``StageFactor`` array + ``kkt0`` solution
    (``gar/riccati-kernel.hpp:35``, ``gar/proximal-riccati.hxx:44-62``).
    Gains with leading time dim T = N+1; ``lff/L/yff/Afb`` index N is unused.
    """

    kff: jax.Array  # (T, nu)      control feedforward
    K: jax.Array  # (T, nu, nx)  control feedback
    zff: jax.Array  # (T, nc)      multiplier feedforward
    Z: jax.Array  # (T, nc, nx)  multiplier feedback
    lff: jax.Array  # (T, nx)      costate feedforward
    L: jax.Array  # (T, nx, nx)  costate feedback
    yff: jax.Array  # (T, nx)      next-state feedforward
    Afb: jax.Array  # (T, nx, nx)  closed-loop state transition
    Pmat: jax.Array  # (T, nx, nx)  value Hessian
    pvec: jax.Array  # (T, nx)      value gradient
    x0: jax.Array  # (nx,)        initial-stage solution
    lam0: jax.Array  # (nc0,)       initial-constraint multiplier
    # --- parametric (θ) branch; None when nth == 0 ---
    Kth: Optional[jax.Array] = None  # (T, nu, nth)
    Zth: Optional[jax.Array] = None  # (T, nc, nth)
    Lth: Optional[jax.Array] = None  # (T, nx, nth)
    Yth: Optional[jax.Array] = None  # (T, nx, nth)
    Vxt: Optional[jax.Array] = None  # (T, nx, nth)
    Vtt: Optional[jax.Array] = None  # (T, nth, nth)
    vt: Optional[jax.Array] = None  # (T, nth)
    x0_th: Optional[jax.Array] = None  # (nx, nth)
    lam0_th: Optional[jax.Array] = None  # (nc0, nth)
    th_grad: Optional[jax.Array] = None  # (nth,)
    th_hess: Optional[jax.Array] = None  # (nth, nth)


def _reduced_kkt_solve(Rhat, D, mueq, rhs_u, rhs_c):
    """Solve [[R̂, D'],[D, -μ_eq I]] [u; ν] = [rhs_u; rhs_c] via SPD Schur.

    Returns (u, ν). rhs may have trailing batch columns.
    """
    W = Rhat + (D.T @ D) / mueq
    u = _chol_solve(_sym(W), rhs_u + (D.T @ rhs_c) / mueq)
    nu = (D @ u - rhs_c) / mueq
    return u, nu


def _reduced_kkt_solve_joint(Rhat, D, mueq, rhs_u_vec, rhs_c_vec,
                             rhs_u_mat, rhs_c_mat):
    """Feedforward + feedback reduced-KKT solves against ONE multi-RHS
    triangular sweep — the (nu,) and (nu, nx[+nth]) right-hand sides share
    one factorization and one traversal (reference solves them separately
    through one BunchKaufman object, riccati-kernel.hxx:166-229).
    Returns (u_vec, nu_vec, U_mat, NU_mat)."""
    W = Rhat + (D.T @ D) / mueq
    Bu = jnp.concatenate([rhs_u_vec[..., None], rhs_u_mat], axis=-1)
    Bc = jnp.concatenate([rhs_c_vec[..., None], rhs_c_mat], axis=-1)
    U = _chol_solve(_sym(W), Bu + (D.T @ Bc) / mueq)
    NU = (D @ U - Bc) / mueq
    return U[..., 0], NU[..., 0], U[..., 1:], NU[..., 1:]


def _terminal_solve(kn, t, mueq, nth):
    """Terminal-stage factor (reference terminalSolve, riccati-kernel.hxx:89)."""
    Q, S, R = kn.Q[t], kn.S[t], kn.R[t]
    q, r = kn.q[t], kn.r[t]
    C, D, d = kn.C[t], kn.D[t], kn.d[t]

    kff, zff, K, Z = _reduced_kkt_solve_joint(R, D, mueq, -r, -d, -S.T, -C)

    P = _sym(Q + C.T @ Z + S @ K)
    p = q + C.T @ zff + S @ kff

    out = dict(kff=kff, K=K, zff=zff, Z=Z, Pmat=P, pvec=p)
    if nth > 0:
        Gx, Gu, Gth, gamma = kn.Gx[t], kn.Gu[t], kn.Gth[t], kn.gamma[t]
        Kth, Zth = _reduced_kkt_solve(
            R, D, mueq, -Gu, jnp.zeros((D.shape[0], Gu.shape[1]), Gu.dtype)
        )
        Vxt = Gx + K.T @ Gu
        Vtt = Gth + Gu.T @ Kth
        vt = gamma + Gu.T @ kff
        out.update(Kth=Kth, Zth=Zth, Vxt=Vxt, Vtt=Vtt, vt=vt)
    return out


def _stage_kernel(knot, carry, mudyn, mueq, assume_explicit, nth,
                  bf16_prop: bool = False):
    """One backward Riccati stage (reference stageKernelSolve,
    riccati-kernel.hxx:166). ``carry`` holds the next stage's value function
    (P, p) and, if parametric, (Vxt, Vtt, vt).

    The products are kept separate rather than packed into wide panels
    (one Schur solve, one reduced-KKT solve, [A|B] GEMMs): packing adds a
    concatenate/slice copy per stage for every merged matmul."""
    Q, S, R = knot["Q"], knot["S"], knot["R"]
    q, r = knot["q"], knot["r"]
    A, B, E, f = knot["A"], knot["B"], knot["E"], knot["f"]
    C, D, d = knot["C"], knot["D"], knot["d"]
    P_n, p_n = carry["P"], carry["p"]
    nx = Q.shape[-1]
    dt = Q.dtype
    eye = jnp.eye(nx, dtype=dt)

    if assume_explicit:
        # E = -I: E^{-1} = E^{-T} = -I
        Ptilde = P_n
        ptilde = p_n
        Einv = None
    else:
        Einv = smallmat.inv(E) if nx <= smallmat._CLOSED_FORM_MAX else jnp.linalg.solve(E, eye)
        Ptilde = _sym(Einv.T @ P_n @ Einv)
        ptilde = -(Einv.T @ p_n)

    schur = eye + mudyn * Ptilde
    schur_sym = _sym_pd(schur)
    schur_solve = _spd_solver(schur_sym)
    # ONE multi-RHS solve for [Vxx | vx] (and one per reduced KKT below):
    # merging the matrix and vector right-hand sides halves the number of
    # triangular-solve traversals per stage and shrinks the traced graph.
    sol = schur_solve(
        jnp.concatenate([Ptilde, (ptilde + Ptilde @ f)[..., None]], axis=-1)
    )
    Vxx = _sym(sol[..., :nx])
    vx = sol[..., nx]

    if bf16_prop:
        # ablation knob: run the value-propagation GEMMs A'V, B'V, A'VA,
        # B'VB, A'VB in bf16 inputs with fp32 accumulation, keeping the KKT
        # core (Schur solve, reduced KKT, gains) in fp32 per the
        # _precision.py policy. Halves the bytes of the widest per-stage
        # operands at medium dims. The second GEMM row deliberately
        # re-rounds the fp32 accumulator AtV/BtV back to bf16 before
        # contracting with A/B — the knob measures the full "bf16 operand
        # traffic" regime with TWO rounding steps per chained product, not
        # a single-rounding mixed-precision dot. Off by default: it costs
        # about two orders of magnitude of dual residual.
        bf = jnp.bfloat16
        Ab, Bb, Vb = A.astype(bf), B.astype(bf), Vxx.astype(bf)
        AtV = jnp.matmul(Ab.T, Vb, preferred_element_type=dt)
        BtV = jnp.matmul(Bb.T, Vb, preferred_element_type=dt)
        Qhat = Q + jnp.matmul(AtV.astype(bf), Ab, preferred_element_type=dt)
        Rhat = R + jnp.matmul(BtV.astype(bf), Bb, preferred_element_type=dt)
        Shat = S + jnp.matmul(AtV.astype(bf), Bb, preferred_element_type=dt)
    else:
        AtV = A.T @ Vxx
        BtV = B.T @ Vxx
        Qhat = Q + AtV @ A
        Rhat = R + BtV @ B
        Shat = S + AtV @ B
    qhat = q + A.T @ vx
    rhat = r + B.T @ vx

    kff, zff, K, Z = _reduced_kkt_solve_joint(
        Rhat, D, mueq, -rhat, -d, -Shat.T, -C
    )

    lff = vx + Vxx @ (B @ kff)
    L = Vxx @ A + Vxx @ (B @ K)
    if assume_explicit:
        yff = f + B @ kff - mudyn * lff
        Afb = A + B @ K - mudyn * L
    else:
        yff = -(Einv @ (f + B @ kff - mudyn * lff))
        Afb = -(Einv @ (A + B @ K - mudyn * L))

    P_c = _sym(Qhat + Shat @ K + C.T @ Z)
    p_c = qhat + Shat @ kff + C.T @ zff

    new_carry = dict(P=P_c, p=p_c)
    out = dict(
        kff=kff, K=K, zff=zff, Z=Z, lff=lff, L=L, yff=yff, Afb=Afb,
        Pmat=P_c, pvec=p_c,
    )

    if nth > 0:
        Gx, Gu, Gth, gamma = knot["Gx"], knot["Gu"], knot["Gth"], knot["gamma"]
        Vxt_n, Vtt_n, vt_n = carry["Vxt"], carry["Vtt"], carry["vt"]
        if assume_explicit:
            Pxttilde = Vxt_n
        else:
            Pxttilde = -(Einv.T @ Vxt_n)
        Pxttilde = schur_solve(Pxttilde)
        Guhat = Gu + B.T @ Pxttilde
        Kth, Zth = _reduced_kkt_solve(
            Rhat, D, mueq, -Guhat, jnp.zeros((D.shape[0], Guhat.shape[1]), dt)
        )
        Lth = Pxttilde + Vxx @ (B @ Kth)
        if assume_explicit:
            Yth = B @ Kth - mudyn * Lth
        else:
            Yth = -(Einv @ (B @ Kth - mudyn * Lth))

        vt_c = vt_n + gamma + Gu.T @ kff + Vxt_n.T @ yff
        Vxt_c = Gx + K.T @ Gu + Afb.T @ Vxt_n
        Vtt_c = Gth + Vtt_n + Gu.T @ Kth + Vxt_n.T @ Yth

        new_carry.update(Vxt=Vxt_c, Vtt=Vtt_c, vt=vt_c)
        out.update(Kth=Kth, Zth=Zth, Lth=Lth, Yth=Yth, Vxt=Vxt_c, Vtt=Vtt_c, vt=vt_c)

    return new_carry, out


def _sym_pd(M):
    return 0.5 * (M + M.T)


def _initial_solve(P0, p0, G0, g0, mudyn, Vxt0=None):
    """Solve the initial KKT [[P0, G0'],[G0, -μ_dyn I]] [x0;λ0] = [-p0;-g0]
    via SPD Schur elimination of λ0 (reference proximal-riccati.hxx:44-62)."""
    W = _sym_pd(P0 + (G0.T @ G0) / mudyn)
    c = jax.scipy.linalg.cho_factor(W, lower=True)

    def solve_rhs(b1, b2):
        x = jax.scipy.linalg.cho_solve(c, b1 + (G0.T @ b2) / mudyn)
        lam = (G0 @ x - b2) / mudyn
        return x, lam

    x0, lam0 = solve_rhs(-p0, -g0)
    if Vxt0 is not None:
        x0_th, lam0_th = solve_rhs(-Vxt0, jnp.zeros((G0.shape[0], Vxt0.shape[1]), Vxt0.dtype))
        return x0, lam0, x0_th, lam0_th
    return x0, lam0, None, None


def sweep(kn: LQRKnots, mudyn, mueq, assume_explicit: bool = False,
          unroll: int = 1, bf16_prop: bool = False):
    """Backward Riccati sweep over a knot sequence (no initial-stage solve).

    Returns ``(carry, stages)`` where ``carry`` is the value function
    propagated to the first knot (P, p[, Vxt, Vtt, vt]) and ``stages`` is a
    dict of stacked per-knot gains (T entries; dynamics-propagation gains at
    the last index are zero). This is the reusable "kernel" shared by the
    serial solver and the per-leg sweeps of the parallel-in-time solver
    (reference ``ProximalRiccatiKernel::backwardImpl``,
    gar/riccati-kernel.hxx:64).
    """
    N = kn.horizon
    nth = kn.nth
    nx = kn.nx
    dt = kn.Q.dtype

    term = _terminal_solve(kn, N, mueq, nth)

    carry0 = dict(P=term["Pmat"], p=term["pvec"])
    if nth > 0:
        carry0.update(Vxt=term["Vxt"], Vtt=term["Vtt"], vt=term["vt"])

    knot_fields = dict(
        Q=kn.Q[:N], S=kn.S[:N], R=kn.R[:N], q=kn.q[:N], r=kn.r[:N],
        A=kn.A[:N], B=kn.B[:N], E=kn.E[:N], f=kn.f[:N],
        C=kn.C[:N], D=kn.D[:N], d=kn.d[:N],
    )
    if nth > 0:
        knot_fields.update(Gx=kn.Gx[:N], Gu=kn.Gu[:N], Gth=kn.Gth[:N], gamma=kn.gamma[:N])

    def scan_body(carry, knot):
        return _stage_kernel(knot, carry, mudyn, mueq, assume_explicit,
                             nth, bf16_prop)

    carry_f, stages = lax.scan(scan_body, carry0, knot_fields,
                               reverse=True, unroll=unroll)

    zero_vec = jnp.zeros((nx,), dt)
    zero_mat = jnp.zeros((nx, nx), dt)

    def cat(name, term_val):
        return jnp.concatenate([stages[name], term_val[None]], axis=0)

    out = dict(
        kff=cat("kff", term["kff"]),
        K=cat("K", term["K"]),
        zff=cat("zff", term["zff"]),
        Z=cat("Z", term["Z"]),
        lff=cat("lff", zero_vec),
        L=cat("L", zero_mat),
        yff=cat("yff", zero_vec),
        Afb=cat("Afb", zero_mat),
        Pmat=cat("Pmat", term["Pmat"]),
        pvec=cat("pvec", term["pvec"]),
    )
    if nth > 0:
        zmat_th = jnp.zeros((nx, nth), dt)
        out.update(
            Kth=cat("Kth", term["Kth"]),
            Zth=cat("Zth", term["Zth"]),
            Lth=cat("Lth", zmat_th),
            Yth=cat("Yth", zmat_th),
            Vxt=cat("Vxt", term["Vxt"]),
            Vtt=cat("Vtt", term["Vtt"]),
            vt=cat("vt", term["vt"]),
        )
    return carry_f, out


@highest_precision
def backward(
    problem: LQRProblem,
    mudyn,
    mueq,
    assume_explicit: bool = False,
    unroll: int = 1,
    bf16_prop: bool = False,
) -> RiccatiFactors:
    """Backward Riccati sweep over the full horizon.

    Returns the full set of gains + the initial-stage solution. Structure of
    the recursion follows ``ProximalRiccatiKernel::backwardImpl``
    (``gar/riccati-kernel.hxx:64``) with the Cholesky-friendly reductions
    described in the module docstring.
    """
    kn = problem.knots
    nth = kn.nth

    carry_f, stages = sweep(kn, mudyn, mueq, assume_explicit,
                            unroll=unroll, bf16_prop=bf16_prop)

    P0, p0 = carry_f["P"], carry_f["p"]
    Vxt0 = carry_f["Vxt"] if nth > 0 else None
    x0, lam0, x0_th, lam0_th = _initial_solve(
        P0, p0, problem.G0, problem.g0, mudyn, Vxt0
    )

    extra = {}
    if nth > 0:
        extra = dict(
            Kth=stages["Kth"],
            Zth=stages["Zth"],
            Lth=stages["Lth"],
            Yth=stages["Yth"],
            Vxt=stages["Vxt"],
            Vtt=stages["Vtt"],
            vt=stages["vt"],
            x0_th=x0_th,
            lam0_th=lam0_th,
            th_grad=carry_f["vt"] + carry_f["Vxt"].T @ x0,
            th_hess=carry_f["Vtt"] + carry_f["Vxt"].T @ x0_th,
        )

    return RiccatiFactors(
        kff=stages["kff"],
        K=stages["K"],
        zff=stages["zff"],
        Z=stages["Z"],
        lff=stages["lff"],
        L=stages["L"],
        yff=stages["yff"],
        Afb=stages["Afb"],
        Pmat=stages["Pmat"],
        pvec=stages["pvec"],
        x0=x0,
        lam0=lam0,
        **extra,
    )


@highest_precision
def forward(
    factors: RiccatiFactors,
    theta: Optional[jax.Array] = None,
    x0: Optional[jax.Array] = None,
    lam0: Optional[jax.Array] = None,
    unroll: int = 1,
):
    """Forward substitution (reference forwardImpl, riccati-kernel.hxx:302).

    Returns ``(xs, us, vs, lams)`` with shapes ``(N+1, ·)``. ``x0``/``lam0``
    override the initial-stage solution (used by the parallel solver to seed
    legs from the condensed system).
    """
    if x0 is None:
        x0 = factors.x0
        if theta is not None and factors.x0_th is not None:
            x0 = x0 + factors.x0_th @ theta
    if lam0 is None:
        lam0 = factors.lam0
        if theta is not None and factors.lam0_th is not None:
            lam0 = lam0 + factors.lam0_th @ theta

    N = factors.kff.shape[0] - 1
    has_th = theta is not None and factors.Kth is not None

    def body(x, t_factors):
        u = t_factors["kff"] + t_factors["K"] @ x
        v = t_factors["zff"] + t_factors["Z"] @ x
        lam_next = t_factors["lff"] + t_factors["L"] @ x
        x_next = t_factors["yff"] + t_factors["Afb"] @ x
        if has_th:
            u = u + t_factors["Kth"] @ theta
            v = v + t_factors["Zth"] @ theta
            lam_next = lam_next + t_factors["Lth"] @ theta
            x_next = x_next + t_factors["Yth"] @ theta
        return x_next, dict(x=x, u=u, v=v, lam_next=lam_next)

    fields = dict(
        kff=factors.kff[:N], K=factors.K[:N], zff=factors.zff[:N],
        Z=factors.Z[:N], lff=factors.lff[:N], L=factors.L[:N],
        yff=factors.yff[:N], Afb=factors.Afb[:N],
    )
    if has_th:
        fields.update(
            Kth=factors.Kth[:N], Zth=factors.Zth[:N],
            Lth=factors.Lth[:N], Yth=factors.Yth[:N],
        )

    xN, outs = lax.scan(body, x0, fields, unroll=unroll)

    uN = factors.kff[N] + factors.K[N] @ xN
    vN = factors.zff[N] + factors.Z[N] @ xN
    if has_th:
        uN = uN + factors.Kth[N] @ theta
        vN = vN + factors.Zth[N] @ theta

    xs = jnp.concatenate([outs["x"], xN[None]], axis=0)
    us = jnp.concatenate([outs["u"], uN[None]], axis=0)
    vs = jnp.concatenate([outs["v"], vN[None]], axis=0)
    lams = jnp.concatenate([lam0[None], outs["lam_next"]], axis=0)
    return xs, us, vs, lams


def solve(problem: LQRProblem, mudyn, mueq, assume_explicit: bool = False,
          theta: Optional[jax.Array] = None):
    """Backward + forward in one call. Returns (xs, us, vs, lams)."""
    factors = backward(problem, mudyn, mueq, assume_explicit)
    return forward(factors, theta=theta)


_GAIN_FIELDS = ("kff", "K", "zff", "Z", "lff", "L", "yff", "Afb")


def use_fused_kernel(platform, dtype, batch_shape, nx, nu, nc0, nth) -> bool:
    """Whether a vmapped :func:`solve_and_gains` runs the fused Triton
    kernel (``pallas_riccati``) rather than the vmapped XLA scan: on a GPU,
    in float32, over exactly one batch axis whose size is a multiple of the
    kernel's block, for the problem structure the kernel covers."""
    from . import pallas_riccati

    return (
        platform == "gpu"
        and dtype == jnp.float32
        and len(batch_shape) == 1
        and batch_shape[0] % pallas_riccati.BLOCK == 0
        and pallas_riccati.covers(nx, nu, nc0, nth)
    )


def _make_solve_and_gains(assume_explicit: bool, unroll: int = 1,
                          bf16_prop: bool = False):
    def scan_path(problem: LQRProblem, mudyn, mueq):
        factors = backward(problem, mudyn, mueq, assume_explicit,
                           unroll=unroll, bf16_prop=bf16_prop)
        xs, us, vs, lams = forward(factors, unroll=unroll)
        gains = {k: getattr(factors, k) for k in _GAIN_FIELDS}
        return xs, us, vs, lams, gains

    @jax.custom_batching.custom_vmap
    def fn(problem: LQRProblem, mudyn, mueq):
        return scan_path(problem, mudyn, mueq)

    @fn.def_vmap
    def _rule(axis_size, in_batched, problem, mudyn, mueq):
        from . import pallas_riccati

        # broadcast unbatched leaves so every leaf carries the batch axis
        def bcast(leaf, is_b):
            leaf = jnp.asarray(leaf)
            return leaf if is_b else jnp.broadcast_to(
                leaf[None], (axis_size,) + leaf.shape
            )

        probs_b, mudyn_b, mueq_b = jax.tree.map(
            bcast, [problem, mudyn, mueq], in_batched
        )

        kn = probs_b.knots
        if use_fused_kernel(
            jax.default_backend(), kn.Q.dtype, kn.Q.shape[:-3],
            kn.nx, kn.nu, probs_b.nc0, kn.nth,
        ):
            out = pallas_riccati.solve(
                probs_b, mudyn_b, mueq_b, return_gains=True,
                assume_explicit=assume_explicit,
            )
        else:
            out = jax.vmap(scan_path)(probs_b, mudyn_b, mueq_b)
        out_batched = jax.tree.map(lambda _: True, out)
        return out, out_batched

    return fn


_SOLVE_AND_GAINS = {}


def _get_solve_and_gains(assume_explicit: bool, unroll: int,
                         bf16_prop: bool):
    # memoized per option tuple: custom_vmap objects must be built once at
    # module scope semantics (rebuilding per call would retrace)
    key = (bool(assume_explicit), int(unroll), bool(bf16_prop))
    fn = _SOLVE_AND_GAINS.get(key)
    if fn is None:
        fn = _SOLVE_AND_GAINS[key] = _make_solve_and_gains(*key)
    return fn


def solve_and_gains(problem: LQRProblem, mudyn, mueq,
                    assume_explicit: bool = True, unroll: int = 1,
                    bf16_prop: bool = False):
    """Solve + per-stage gains, with a fused-kernel path under vmap.

    Unbatched, this is ``backward`` + ``forward`` (the XLA scan path). Under
    ``vmap`` — the batched-MPC execution model — the whole batch goes to the
    fused Triton kernel (``pallas_riccati``) when :func:`use_fused_kernel`
    says so: GPU, fp32, batch a multiple of the kernel's block, small dims,
    no θ-block. This is the mechanism that lets ``jax.vmap(proxddp.solve)``
    reach the fused kernel without the solver knowing about batching.
    ``mudyn``/``mueq`` may be traced and, under vmap, per-element (each
    scenario's BCL μ-schedule evolves independently). ``assume_explicit``
    selects the E = −I fast path; with ``False`` the kernel inverts the
    stage E-blocks (manifold difference-chart Jacobians).

    ``unroll`` unrolls k stages per scan step on the XLA path;
    ``bf16_prop`` runs the value-propagation GEMMs in bf16 with fp32
    accumulation (the KKT core stays fp32). Both are no-ops on the fused
    kernel.
    """
    return _get_solve_and_gains(assume_explicit, unroll, bf16_prop)(
        problem, mudyn, mueq
    )


def solve_refined(
    problem: LQRProblem,
    mudyn,
    mueq,
    assume_explicit: bool = False,
    refine_steps: int = 1,
):
    """Solve + iterative refinement: re-solve on the KKT residual and
    correct (z ← z − δ with M δ = residual). Each step costs one extra
    backward/forward sweep and squares the effective precision — the fp32
    answer reaches fp32-roundoff-of-the-true-solution instead of
    recursion-accumulated error (the reference's refinement loops play this
    role, e.g. ``parallel-solver.hxx:156-175``)."""
    from .._pytree import replace as _replace
    from .lqr_problem import kkt_residual_vectors

    xs, us, vs, lams = solve(problem, mudyn, mueq, assume_explicit)
    N = problem.horizon
    for _ in range(refine_steps):
        g0r, gx, gu, cstr, dyn = kkt_residual_vectors(
            problem, xs, us, vs, lams, mudyn, mueq
        )
        kn_r = _replace(
            problem.knots,
            q=gx,
            r=gu,
            d=cstr,
            f=jnp.concatenate([dyn, jnp.zeros_like(dyn[:1])], axis=0),
        )
        prob_r = _replace(problem, knots=kn_r, g0=g0r)
        # solve() returns δ with M δ = −residual, so the correction is z += δ
        dxs, dus, dvs, dlams = solve(prob_r, mudyn, mueq, assume_explicit)
        xs = xs + dxs
        us = us + dus
        vs = vs + dvs
        lams = lams + dlams
    return xs, us, vs, lams


def solve_guarded(problem: LQRProblem, mudyn, mueq,
                  assume_explicit: bool = False, method: str = "serial",
                  legs: int = 2, refine_steps: int = 1):
    """Riccati solve with a runtime failed-factorization guard.

    The structured sweeps (serial scan and parallel legs) use pivot-free
    SPD Cholesky kernels whose numerical domain is jointly convex stage
    costs (what ProxDDP emits by construction).  On *indefinite* stage
    blocks — which the reference covers with Bunch-Kaufman pivoting
    (``gar/riccati-kernel.hxx``) — a sweep can hit a negative pivot and
    NaN out.  This entry point detects any non-finite output and falls
    back (``lax.cond``) to the dense-KKT LU factorization
    (:func:`lqr_problem.dense_solve`), which handles the indefinite class,
    mirroring the associative solver's runtime μ-floor guard.  This is the
    recommended standalone entry point for arbitrary LQ problems.

    Caveat: under ``vmap``, ``lax.cond`` lowers to ``select`` and the
    dense branch executes for the whole batch — keep the raw
    :func:`solve` / :func:`parallel.solve` in batched hot paths (where
    the convex domain holds anyway).
    """
    if method == "serial":
        sol = solve(problem, mudyn, mueq, assume_explicit)
    elif method == "parallel":
        from . import parallel as _parallel

        sol = _parallel.solve(
            problem, mudyn, mueq, legs=legs,
            assume_explicit=assume_explicit, refine_steps=refine_steps,
        )
    else:
        raise ValueError(f"unknown method {method!r}")

    from .lqr_problem import dense_solve

    ok = jnp.all(
        jnp.stack([jnp.all(jnp.isfinite(s)) for s in sol])
    )
    return jax.lax.cond(
        ok,
        lambda _: sol,
        lambda _: dense_solve(problem, mudyn, mueq),
        None,
    )
