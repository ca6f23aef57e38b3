"""Parallel-in-time proximal Riccati via ``jax.lax.associative_scan``.

The serial backward sweep (``riccati.py``) has O(N) sequential depth — the
wall-clock floor for a single long-horizon MPC solve. This module
re-expresses the same μ-regularized value recursion as an associative
operation on 5-tuples ``(A, b, C, η, J)`` (the parallel LQT formulation of
Särkkä & García-Fernández, "Temporal parallelization of Bayesian smoothers",
2020 — see also PAPERS.md "The Parallelization of Riccati Recursion"), so
both sweeps run in O(log N) depth:

* element = the optimal conditional cost-to-go map of a stage interval,
  ``V(x_t | x_s) = ½ x_tᵀ J x_t − ηᵀ x_t  (+ boundary terms)`` with closed-
  loop state map ``x_s = A x_t + b`` and "control reachability" Gramian C;
* the stagewise ALM penalty folds the projected constraints into an
  effective cost (``Q̄ = Q + CᵀC/μ_eq`` …), exactly equivalent to the
  reduced-KKT elimination of the serial kernel;
* the dual-proximal relaxation of the dynamics (the serial
  ``(I + μ_dyn P̃)⁻¹`` Schur trick) appears as process noise ``μ_dyn·I``
  added to each leaf's C — the LQG/LQR correspondence makes the parallel
  form *bit-for-bit the same recursion*, validated against the serial
  solver in ``tests/gar/test_associative.py``;
* per-stage gains are recovered afterwards by running the serial stage
  kernel **in parallel across stages** (each stage only needs the scanned
  value function of its successor), and the closed-loop forward rollout is
  a second associative scan over affine maps.

Role in the stack: ``ProxDDPConfig(linear_solver='associative')``; the
latency-optimal choice for ONE long-horizon problem (the leg-condensation
solver in ``parallel.py`` remains the throughput choice for multi-device
time sharding; the fused Pallas kernel the choice for large batches).
Explicit dynamics (E = −I), ``nth == 0``.

Reference counterpart: aligator's parallel LQ solver
(``gar/parallel-solver.hpp:34``) splits the horizon into legs — a 2-level
condensation; this is the full-depth O(log N) version, which only makes
sense on hardware with massive data parallelism per time step (GPUs),
not on the reference's CPU thread pools.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._precision import highest_precision
from . import riccati, smallmat
from .lqr_problem import LQRProblem


def _solve(M, B):
    """Nonsymmetric small solve for the combine's (I + C J) matrices.

    These carry the folded 1/μ_eq constraint penalty, so they can be
    μ-scaled/ill-conditioned — the raw closed-form inverse is not enough
    (CLAUDE.md precision policy). Three Newton refinement steps square the
    inverse's residual each time: starting from the adjugate's
    cond·eps ≈ 1e-1 worst case at μ ≈ 1e-6 in fp32, three steps reach
    ~1e-8, i.e. factorization-grade."""
    return smallmat.solve(M, B, newton_iters=3)


def _fold_constraints(kn, t_slice, mueq):
    """Effective stage cost with the ALM constraint penalty folded in
    (equivalent to the serial reduced-KKT elimination of ν)."""
    Q, S, R = kn.Q[t_slice], kn.S[t_slice], kn.R[t_slice]
    q, r = kn.q[t_slice], kn.r[t_slice]
    C, D, d = kn.C[t_slice], kn.D[t_slice], kn.d[t_slice]
    Ct = jnp.swapaxes(C, -1, -2)
    Dt = jnp.swapaxes(D, -1, -2)
    Qb = Q + (Ct @ C) / mueq
    Sb = S + (Ct @ D) / mueq
    Rb = R + (Dt @ D) / mueq
    qb = q + (Ct @ d[..., None])[..., 0] / mueq
    rb = r + (Dt @ d[..., None])[..., 0] / mueq
    return Qb, Sb, Rb, qb, rb


@highest_precision
def backward_scan(problem: LQRProblem, mudyn, mueq):
    """Associative backward sweep. Returns stacked value functions
    ``(P, p)`` with leading time axis T = N+1 (``P[t] = P_t``)."""
    kn = problem.knots
    N = kn.horizon
    nx = kn.nx
    dt = kn.Q.dtype
    eye = jnp.eye(nx, dtype=dt)

    # --- leaf elements for stages 0..N-1 ---
    Qb, Sb, Rb, qb, rb = _fold_constraints(kn, slice(0, N), mueq)
    A, B, f = kn.A[:N], kn.B[:N], kn.f[:N]
    Bt = jnp.swapaxes(B, -1, -2)
    Sbt = jnp.swapaxes(Sb, -1, -2)
    solve_R = smallmat.spd_solver(0.5 * (Rb + jnp.swapaxes(Rb, -1, -2)))
    RiSt = solve_R(Sbt)  # R̄⁻¹ S̄ᵀ
    RiBt = solve_R(Bt)  # R̄⁻¹ Bᵀ
    Rir = solve_R(rb)  # R̄⁻¹ r̄
    A_e = A - B @ RiSt
    b_e = f - (B @ Rir[..., None])[..., 0]
    C_e = B @ RiBt + mudyn * eye
    J_e = Qb - Sb @ RiSt
    J_e = 0.5 * (J_e + jnp.swapaxes(J_e, -1, -2))
    eta_e = -(qb - (Sb @ Rir[..., None])[..., 0])

    # --- terminal element: the terminal knot's own reduced cost ---
    term = riccati._terminal_solve(kn, N, mueq, 0)
    P_T, p_T = term["Pmat"], term["pvec"]
    zmat = jnp.zeros((1, nx, nx), dt)
    zvec = jnp.zeros((1, nx), dt)
    elems = dict(
        A=jnp.concatenate([A_e, zmat], axis=0),
        b=jnp.concatenate([b_e, zvec], axis=0),
        C=jnp.concatenate([C_e, zmat], axis=0),
        eta=jnp.concatenate([eta_e, -p_T[None]], axis=0),
        J=jnp.concatenate([J_e, P_T[None]], axis=0),
    )

    def combine(later, earlier):
        # reverse=True feeds (later-interval, earlier-interval); the
        # composed element applies the later map first
        e1, e2 = earlier, later  # e1 = closer to t=0, e2 = closer to T
        n = e1["A"].shape[-1]
        I = jnp.eye(n, dtype=e1["A"].dtype)
        CJ = I + e1["C"] @ e2["J"]  # (I + C₁ J₂)
        JC = I + e2["J"] @ e1["C"]  # (I + J₂ C₁)
        A1, A2 = e1["A"], e2["A"]
        A1t = jnp.swapaxes(A1, -1, -2)
        A2t = jnp.swapaxes(A2, -1, -2)
        X = _solve(CJ, A1)  # (I+C₁J₂)⁻¹ A₁
        Y = _solve(CJ, e1["C"])  # (I+C₁J₂)⁻¹ C₁
        A_c = A2 @ X
        b_c = (
            (A2 @ _solve(CJ, (e1["b"] + (e1["C"] @ e2["eta"][..., None])[..., 0])[..., None]))[..., 0]
            + e2["b"]
        )
        C_c = A2 @ Y @ A2t + e2["C"]
        C_c = 0.5 * (C_c + jnp.swapaxes(C_c, -1, -2))
        rhs = (e2["eta"] - (e2["J"] @ e1["b"][..., None])[..., 0])[..., None]
        eta_c = (A1t @ _solve(JC, rhs))[..., 0] + e1["eta"]
        J_c = A1t @ _solve(JC, e2["J"]) @ A1 + e1["J"]
        J_c = 0.5 * (J_c + jnp.swapaxes(J_c, -1, -2))
        return dict(A=A_c, b=b_c, C=C_c, eta=eta_c, J=J_c)

    # suffix products: scanned[t] = elem_t ⊗ … ⊗ elem_N  →  (P_t, p_t)
    scanned = jax.lax.associative_scan(combine, elems, reverse=True)
    P = scanned["J"]
    p = -scanned["eta"]
    return P, p


@highest_precision
def solve(problem: LQRProblem, mudyn, mueq, return_gains: bool = False,
          refine_steps: int = 0):
    """Full parallel-in-time solve: O(log N)-depth backward value scan,
    stage-parallel gain recovery, O(log N)-depth closed-loop forward scan.

    Returns ``(xs, us, vs, lams)`` (+ a RiccatiFactors when
    ``return_gains``), matching ``riccati.solve(…, assume_explicit=True)``.

    Conditioning note: folding the ALM penalty into the leaf costs squares
    the 1/μ_eq scale inside the element algebra, so at extreme penalties
    the raw scan loses digits relative to the serial reduced-KKT recursion,
    and below a dtype-dependent floor the folded operator stops being a
    contraction and refinement DIVERGES — measured domains: μ ≳ 1e-7 in
    fp64, **μ ≳ 1e-3 in fp32** (at fp32 μ = 1e-4 the solution is garbage
    regardless of refinement; use the serial path there).
    ``refine_steps ≥ 1`` runs
    KKT-residual refinement (each step re-solves on the residual — still
    O(log N) depth) and restores solver-grade accuracy.
    """
    kn = problem.knots
    N = kn.horizon
    if kn.nth != 0:
        raise ValueError("associative solver supports nth == 0 only")

    P, p = backward_scan(problem, mudyn, mueq)

    # --- stage-parallel gain recovery: stage t needs only (P_{t+1}, p_{t+1})
    knot_fields = dict(
        Q=kn.Q[:N], S=kn.S[:N], R=kn.R[:N], q=kn.q[:N], r=kn.r[:N],
        A=kn.A[:N], B=kn.B[:N], E=kn.E[:N], f=kn.f[:N],
        C=kn.C[:N], D=kn.D[:N], d=kn.d[:N],
    )
    carry = dict(P=P[1:], p=p[1:])

    def stage(knot, cr):
        _, out = riccati._stage_kernel(knot, cr, mudyn, mueq, True, 0)
        return out

    stages = jax.vmap(stage)(knot_fields, carry)

    term = riccati._terminal_solve(kn, N, mueq, 0)
    pad_mat = jnp.zeros_like(stages["L"][:1])
    pad_vec = jnp.zeros_like(stages["lff"][:1])

    def cat(name, term_val):
        return jnp.concatenate([stages[name], term_val[None]], axis=0)

    kff = cat("kff", term["kff"])
    K = cat("K", term["K"])
    zff = cat("zff", term["zff"])
    Z = cat("Z", term["Z"])
    lff = jnp.concatenate([stages["lff"], pad_vec], axis=0)
    L = jnp.concatenate([stages["L"], pad_mat], axis=0)
    yff = jnp.concatenate([stages["yff"], pad_vec], axis=0)
    Afb = jnp.concatenate([stages["Afb"], pad_mat], axis=0)

    x0, lam0, _, _ = riccati._initial_solve(
        P[0], p[0], problem.G0, problem.g0, mudyn
    )

    # --- forward rollout as an associative scan over affine maps ---
    # x_{t+1} = Afb_t x_t + yff_t ; compose (M, v): x ↦ M x + v
    def fcombine(left, right):
        # prefix products in time order: right applied after left
        M = right[0] @ left[0]
        v = (right[0] @ left[1][..., None])[..., 0] + right[1]
        return (M, v)

    maps = (Afb[:N], yff[:N])
    pref = jax.lax.associative_scan(fcombine, maps)
    # xs[0] = x0 ; xs[t+1] = pref[t] applied to x0
    xs_tail = (pref[0] @ x0) + pref[1]
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)

    us = kff + (K @ xs[..., None])[..., 0]
    vs = zff + (Z @ xs[..., None])[..., 0]
    lams_tail = lff[:N] + (L[:N] @ xs[:N, :, None])[..., 0]
    lams = jnp.concatenate([lam0[None], lams_tail], axis=0)

    for _ in range(refine_steps):
        from .._pytree import replace as _replace
        from .lqr_problem import kkt_residual_vectors

        g0r, gx, gu, cstr, dyn = kkt_residual_vectors(
            problem, xs, us, vs, lams, mudyn, mueq
        )
        kn_r = _replace(
            kn,
            q=gx,
            r=gu,
            d=cstr,
            f=jnp.concatenate([dyn, jnp.zeros_like(dyn[:1])], axis=0),
        )
        prob_r = _replace(problem, knots=kn_r, g0=g0r)
        dxs, dus, dvs, dlams = solve(prob_r, mudyn, mueq)
        xs = xs + dxs
        us = us + dus
        vs = vs + dvs
        lams = lams + dlams

    if not return_gains:
        return xs, us, vs, lams
    factors = riccati.RiccatiFactors(
        kff=kff, K=K, zff=zff, Z=Z, lff=lff, L=L, yff=yff, Afb=Afb,
        Pmat=P, pvec=p, x0=x0, lam0=lam0,
    )
    return xs, us, vs, lams, factors
