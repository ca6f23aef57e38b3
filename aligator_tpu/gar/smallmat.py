"""Closed-form small-matrix inverses/solves.

Performance core: inside the Riccati `lax.scan`, per-stage factorizations act
on tiny matrices (nx, nu ≤ ~6 for the headline MPC workloads). LAPACK-style
``cho_factor``/``lu`` primitives launch several kernels per call and
serialize inside a scan; closed-form adjugate inverses are pure elementwise
arithmetic that XLA fuses into the surrounding step.

Dispatch is on the *static* trailing dimension: n ≤ 4 → closed form,
otherwise fall back to Cholesky/LU. All matrices here are either SPD (the
μ-regularized reduced KKT and Schur matrices) or well-conditioned small E
blocks, so the adjugate route is numerically safe at these sizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_CLOSED_FORM_MAX = 4


def _refine(M, X):
    """One Newton step X ← X(2I − MX): doubles the accuracy of an
    approximate inverse at the cost of two fused matmuls."""
    n = M.shape[-1]
    eye = jnp.eye(n, dtype=M.dtype)
    return X @ (2.0 * eye - M @ X)


def inv(M, newton_iters: int = 1):
    """Inverse of a small square matrix: closed form for n ≤ 4, plus
    ``newton_iters`` Newton refinement steps to recover factorization-level
    accuracy (each step squares the residual of the approximate inverse —
    pass 3 for μ-scaled matrices with cond up to ~1/eps(fp32), where the raw
    adjugate alone is NOT acceptable)."""
    n = M.shape[-1]
    X = _inv_closed(M)
    if n >= 3 or newton_iters > 1:
        for _ in range(newton_iters):
            X = _refine(M, X)
    return X


def _inv_closed(M):
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        row0 = jnp.stack([d, -b], -1)
        row1 = jnp.stack([-c, a], -1)
        return jnp.stack([row0, row1], -2) / det[..., None, None]
    if n == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        D = -(b * i - c * h)
        E = a * i - c * g
        F = -(a * h - b * g)
        G = b * f - c * e
        H = -(a * f - c * d)
        I = a * e - b * d
        det = a * A + b * B + c * C
        adjT = jnp.stack(
            [
                jnp.stack([A, D, G], -1),
                jnp.stack([B, E, H], -1),
                jnp.stack([C, F, I], -1),
            ],
            -2,
        )
        return adjT / det[..., None, None]
    if n == 4:
        # blockwise: [[P, Q], [R, S]] with 2x2 blocks; Schur on S
        P, Q = M[..., :2, :2], M[..., :2, 2:]
        R, S = M[..., 2:, :2], M[..., 2:, 2:]
        Si = inv(S)
        SiR = Si @ R
        T = inv(P - Q @ SiR)  # Schur complement inverse
        TQSi = T @ (Q @ Si)
        top = jnp.concatenate([T, -TQSi], axis=-1)
        bot = jnp.concatenate([-SiR @ T, Si + SiR @ TQSi], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)
    raise ValueError(f"closed-form inverse not defined for n={n}")


def solve(M, B, newton_iters: int = 1):
    """Solve M X = B; closed form for n ≤ 4 (see ``inv`` for the
    refinement policy), LU otherwise."""
    n = M.shape[-1]
    if n <= _CLOSED_FORM_MAX:
        Minv = inv(M, newton_iters=newton_iters)
        return Minv @ B if B.ndim == M.ndim else (Minv @ B[..., None])[..., 0]
    return jnp.linalg.solve(M, B)


def chol_small(M):
    """Hand-unrolled Cholesky factor L (lower) for n ≤ 4: scalar arithmetic
    only (sqrt/div), numerically identical to LAPACK but fully fuseable."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    zero = jnp.zeros_like(M[..., 0, 0])
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
        for i in range(n)
    ]
    return jnp.stack(rows, -2)


def _tri_solve_lower(L, B):
    """Solve L X = B with L lower-triangular, unrolled (B: (..., n) or
    (..., n, m))."""
    n = L.shape[-1]
    vec = B.ndim == L.ndim - 1
    rows = [B[..., i] if vec else B[..., i, :] for i in range(n)]
    out = [None] * n
    for i in range(n):
        s = rows[i]
        for k in range(i):
            lik = L[..., i, k] if vec else L[..., i, k][..., None]
            s = s - lik * out[k]
        lii = L[..., i, i] if vec else L[..., i, i][..., None]
        out[i] = s / lii
    return jnp.stack(out, -1 if vec else -2)


def _tri_solve_upper_t(L, B):
    """Solve Lᵀ X = B (L lower-triangular), unrolled."""
    n = L.shape[-1]
    vec = B.ndim == L.ndim - 1
    rows = [B[..., i] if vec else B[..., i, :] for i in range(n)]
    out = [None] * n
    for i in reversed(range(n)):
        s = rows[i]
        for k in range(i + 1, n):
            lki = L[..., k, i] if vec else L[..., k, i][..., None]
            s = s - lki * out[k]
        lii = L[..., i, i] if vec else L[..., i, i][..., None]
        out[i] = s / lii
    return jnp.stack(out, -1 if vec else -2)


# Above this size, fall back to LAPACK-style primitives; below it (and
# above _CLOSED_FORM_MAX) use the recursive block algorithms, whose heavy
# ops are batched GEMMs — unlike ``cho_factor``, whose blocked while-loop
# serializes inside a ``lax.scan``.
_BLOCKED_MAX = 64


def chol_blocked(M):
    """Recursive block Cholesky: L11 = chol(A); L21 = B L11^-T;
    L22 = chol(C - L21 L21'). Backward-stable (it IS Cholesky, organized
    so every large op is a batched matmul). Bottoms out at the unrolled
    scalar kernel."""
    n = M.shape[-1]
    if n <= _CLOSED_FORM_MAX:
        return chol_small(M)
    n1 = n // 2
    A = M[..., :n1, :n1]
    Bb = M[..., n1:, :n1]
    C = M[..., n1:, n1:]
    L11 = chol_blocked(A)
    # L21 = B L11^{-T}  <=>  L11 L21' = B'
    L21 = jnp.swapaxes(tri_solve_lower(L11, jnp.swapaxes(Bb, -1, -2)), -1, -2)
    S = C - L21 @ jnp.swapaxes(L21, -1, -2)
    L22 = chol_blocked(0.5 * (S + jnp.swapaxes(S, -1, -2)))
    top = jnp.concatenate(
        [L11, jnp.zeros(M.shape[:-2] + (n1, n - n1), M.dtype)], axis=-1
    )
    bot = jnp.concatenate([L21, L22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def tri_solve_lower(L, B):
    """Solve L X = B, L lower-triangular, recursive blocks / unrolled tiny."""
    n = L.shape[-1]
    if n <= _CLOSED_FORM_MAX:
        return _tri_solve_lower(L, B)
    n1 = n // 2
    vec = B.ndim == L.ndim - 1
    B1 = B[..., :n1] if vec else B[..., :n1, :]
    B2 = B[..., n1:] if vec else B[..., n1:, :]
    L21 = L[..., n1:, :n1]
    X1 = tri_solve_lower(L[..., :n1, :n1], B1)
    upd = (L21 @ X1[..., None])[..., 0] if vec else L21 @ X1
    X2 = tri_solve_lower(L[..., n1:, n1:], B2 - upd)
    return jnp.concatenate([X1, X2], axis=-1 if vec else -2)


def tri_solve_upper_t(L, B):
    """Solve L' X = B, L lower-triangular, recursive blocks."""
    n = L.shape[-1]
    if n <= _CLOSED_FORM_MAX:
        return _tri_solve_upper_t(L, B)
    n1 = n // 2
    vec = B.ndim == L.ndim - 1
    B1 = B[..., :n1] if vec else B[..., :n1, :]
    B2 = B[..., n1:] if vec else B[..., n1:, :]
    L21t = jnp.swapaxes(L[..., n1:, :n1], -1, -2)
    X2 = tri_solve_upper_t(L[..., n1:, n1:], B2)
    upd = (L21t @ X2[..., None])[..., 0] if vec else L21t @ X2
    X1 = tri_solve_upper_t(L[..., :n1, :n1], B1 - upd)
    return jnp.concatenate([X1, X2], axis=-1 if vec else -2)


def spd_block_inv(M, newton_iters: int = 1):
    """Explicit inverse of a WELL-CONDITIONED SPD matrix via recursive
    2x2-block Schur complements — every heavy op is a batched GEMM (no
    triangular-solve pyramids), plus ``newton_iters`` Newton refinement
    steps at the top level (X ← X(2I − MX), each squares the residual).

    Use ONLY where conditioning is a priori bounded. The proximal Schur
    matrix ``I + μ_dyn·P̃`` qualifies: eigs lie in [1, 1+μλmax(P)], so its
    condition number IMPROVES as μ shrinks — the opposite of the 1/μ-scaled
    reduced-KKT ``R̂ + D'D/μ_eq`` blocks, which must keep Cholesky (the
    CLAUDE.md adjugate prohibition is about those). Motivation: the
    recursive-Cholesky solve is a deep recursion of tiny ops; this inverse
    is GEMM-bound.
    """
    n = M.shape[-1]

    def block_inv(M):
        n = M.shape[-1]
        if n <= _CLOSED_FORM_MAX:
            # raw closed form; refinement happens once at the top level
            return _inv_closed(M)
        n1 = n // 2
        A = M[..., :n1, :n1]
        Bb = M[..., n1:, :n1]
        C = M[..., n1:, n1:]
        Ai = block_inv(A)
        BAi = Bb @ Ai
        S = C - BAi @ jnp.swapaxes(Bb, -1, -2)
        T = block_inv(0.5 * (S + jnp.swapaxes(S, -1, -2)))
        X21 = -(T @ BAi)
        X11 = Ai - jnp.swapaxes(BAi, -1, -2) @ X21
        top = jnp.concatenate([X11, jnp.swapaxes(X21, -1, -2)], axis=-1)
        bot = jnp.concatenate(
            [X21, T], axis=-1
        )
        return jnp.concatenate([top, bot], axis=-2)

    X = block_inv(M)
    for _ in range(newton_iters):
        X = _refine(M, X)
    return 0.5 * (X + jnp.swapaxes(X, -1, -2))


def solve_spd(M, B):
    """Solve with M symmetric positive definite (unrolled Cholesky for tiny
    M, recursive block Cholesky up to n=64 — LAPACK-grade accuracy, no
    while-loop primitives inside scans)."""
    n = M.shape[-1]
    if n <= _BLOCKED_MAX:
        L = chol_blocked(M)
        Y = tri_solve_lower(L, B)
        return tri_solve_upper_t(L, Y)
    c = jax.scipy.linalg.cho_factor(M, lower=True)
    return jax.scipy.linalg.cho_solve(c, B)


def spd_solver(M):
    """Amortized SPD solver closure (factor once, solve many)."""
    n = M.shape[-1]
    if n <= _BLOCKED_MAX:
        L = chol_blocked(M)

        def solve_(B):
            Y = tri_solve_lower(L, B)
            return tri_solve_upper_t(L, Y)

        return solve_
    c = jax.scipy.linalg.cho_factor(M, lower=True)
    return lambda B: jax.scipy.linalg.cho_solve(c, B)
