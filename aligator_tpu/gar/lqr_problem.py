"""Proximal LQ problem data model (the `gar` layer).

Accelerator-native re-design of the reference's LQ problem container
(``include/aligator/gar/lqr-problem.hpp:32,198``): instead of a vector of
heterogeneous per-stage knot objects, a :class:`LQRKnots` is a pytree of
arrays *stacked over time* with uniform static dims ``(nx, nu, nc)`` — the
shape XLA wants for `lax.scan` / `vmap` / sharding. Heterogeneous stage
dimensions are handled upstream by padding (identity rows + zero couplings).

One stage ``t`` of the proximal LQ problem:

  cost        1/2 x'Q x + x'S u + 1/2 u'R u + q'x + r'u
  dynamics    A x_t + B u_t + E x_{t+1} + f = 0        (dual-regularized, mudyn)
  constraint  C x_t + D u_t + d = 0                    (dual-regularized, mueq)

plus an initial-condition constraint ``G0 x_0 + g0 = 0`` and optional
parametric blocks ``(Gx, Gu, Gth, gamma)`` coupling a parameter vector θ
(used for parallel-in-time leg condensing and MPC sensitivities).

The stationarity ("KKT") conditions solved by the Riccati solvers are exactly
those checked by :func:`kkt_error`, which mirrors the reference test oracle
``lqrComputeKktError`` (``include/aligator/gar/utils.hxx:95``).

Index convention: all fields have leading time dim ``T = N+1``; dynamics
fields ``A, B, E, f`` at index ``N`` are unused (keep them zero).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass


@pytree_dataclass
class LQRKnots:
    """Stacked LQ stage data. Leading dim is time ``T = N+1``."""

    Q: jax.Array  # (T, nx, nx)
    S: jax.Array  # (T, nx, nu)
    R: jax.Array  # (T, nu, nu)
    q: jax.Array  # (T, nx)
    r: jax.Array  # (T, nu)
    A: jax.Array  # (T, nx, nx)   [index N unused]
    B: jax.Array  # (T, nx, nu)   [index N unused]
    E: jax.Array  # (T, nx, nx)   [index N unused]
    f: jax.Array  # (T, nx)       [index N unused]
    C: jax.Array  # (T, nc, nx)
    D: jax.Array  # (T, nc, nu)
    d: jax.Array  # (T, nc)
    # Optional parametric blocks (θ of dim nth). None when nth == 0.
    Gx: Optional[jax.Array] = None  # (T, nx, nth)
    Gu: Optional[jax.Array] = None  # (T, nu, nth)
    Gth: Optional[jax.Array] = None  # (T, nth, nth)
    gamma: Optional[jax.Array] = None  # (T, nth)

    @property
    def horizon(self) -> int:
        return self.Q.shape[-3] - 1

    @property
    def nx(self) -> int:
        return self.Q.shape[-1]

    @property
    def nu(self) -> int:
        return self.R.shape[-1]

    @property
    def nc(self) -> int:
        return self.C.shape[-2]

    @property
    def nth(self) -> int:
        return 0 if self.Gx is None else self.Gx.shape[-1]


@pytree_dataclass
class LQRProblem:
    """LQ problem over horizon N: knots + initial-condition constraint.

    Mirrors the role of ``LqrProblemTpl`` (reference
    ``gar/lqr-problem.hpp:198``).
    """

    knots: LQRKnots
    G0: jax.Array  # (nc0, nx)
    g0: jax.Array  # (nc0,)

    @property
    def horizon(self) -> int:
        return self.knots.horizon

    @property
    def nc0(self) -> int:
        return self.G0.shape[-2]

    @property
    def nx(self) -> int:
        return self.knots.nx

    @property
    def nu(self) -> int:
        return self.knots.nu

    @property
    def nc(self) -> int:
        return self.knots.nc

    @property
    def nth(self) -> int:
        return self.knots.nth


def add_parameterization(knots: LQRKnots, nth: int) -> LQRKnots:
    """Return knots extended with zero parametric blocks of dim ``nth``.

    Counterpart of ``LqrKnotTpl::addParameterization`` used by the
    parallel-in-time solver (reference ``gar/parallel-solver.hxx:52-61``).
    """
    T = knots.Q.shape[0]
    dt = knots.Q.dtype
    from .._pytree import replace

    return replace(
        knots,
        Gx=jnp.zeros((T, knots.nx, nth), dt),
        Gu=jnp.zeros((T, knots.nu, nth), dt),
        Gth=jnp.zeros((T, nth, nth), dt),
        gamma=jnp.zeros((T, nth), dt),
    )


def random_wishart(key, n: int, dof: int, dtype=jnp.float64) -> jax.Array:
    """Random PSD matrix, Wishart-style (reference ``tests/gar/test_util.hpp:64``)."""
    root = jax.random.normal(key, (n, dof), dtype=dtype)
    return root @ root.T / dof


def random_problem(
    key,
    N: int,
    nx: int,
    nu: int,
    nc: int,
    nc0: Optional[int] = None,
    dtype=jnp.float32,
) -> LQRProblem:
    """Generate a random well-posed proximal LQ problem (test utility).

    Terminal knot is padded: ``R_N = I, S_N = 0, r_N = 0`` so that the
    (uniform-shape) terminal control decouples and solves to zero, and the
    dynamics blocks at index N are zero. ``E = -I`` throughout (the explicit
    dynamics convention).
    """
    if nc0 is None:
        nc0 = nx
    T = N + 1
    keys = jax.random.split(key, 12)

    def batch_wishart(k, n, dof):
        ks = jax.random.split(k, T)
        return jax.vmap(lambda kk: random_wishart(kk, n, dof, dtype))(ks)

    Q = batch_wishart(keys[0], nx, nx + 2)
    R = batch_wishart(keys[1], nu, nu + 2)
    # keep R comfortably positive definite
    R = R + 0.1 * jnp.eye(nu, dtype=dtype)
    S = 0.1 * jax.random.normal(keys[2], (T, nx, nu), dtype=dtype)
    q = jax.random.normal(keys[3], (T, nx), dtype=dtype)
    r = jax.random.normal(keys[4], (T, nu), dtype=dtype)

    A = jax.random.normal(keys[5], (T, nx, nx), dtype=dtype) / jnp.asarray(
        jnp.sqrt(nx), dtype
    )
    B = jax.random.normal(keys[6], (T, nx, nu), dtype=dtype) / jnp.asarray(
        jnp.sqrt(nu), dtype
    )
    E = jnp.broadcast_to(-jnp.eye(nx, dtype=dtype), (T, nx, nx))
    f = 0.1 * jax.random.normal(keys[7], (T, nx), dtype=dtype)

    C = jax.random.normal(keys[8], (T, nc, nx), dtype=dtype)
    D = jax.random.normal(keys[9], (T, nc, nu), dtype=dtype)
    d = jax.random.normal(keys[10], (T, nc), dtype=dtype)

    # pad the terminal knot
    eye_u = jnp.eye(nu, dtype=dtype)
    R = R.at[N].set(eye_u)
    S = S.at[N].set(0.0)
    r = r.at[N].set(0.0)
    D = D.at[N].set(0.0)
    zpad = jnp.zeros_like(A[N])
    A = A.at[N].set(zpad)
    B = B.at[N].set(0.0)
    E = E.at[N].set(zpad)
    f = f.at[N].set(0.0)

    knots = LQRKnots(Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, E=E, f=f, C=C, D=D, d=d)

    G0 = jnp.eye(nc0, nx, dtype=dtype)
    g0 = jax.random.normal(keys[11], (nc0,), dtype=dtype)
    return LQRProblem(knots=knots, G0=G0, g0=g0)


def random_convex_problem(
    key,
    N: int,
    nx: int,
    nu: int,
    nc: int,
    nc0: Optional[int] = None,
    dtype=jnp.float64,
) -> LQRProblem:
    """Random LQ problem with JOINTLY convex stage costs: every
    ``[[Q, S], [S', R]]`` block is a single Wishart draw, so it is PSD
    (plus a small ridge on R).

    This is the class of LQ subproblem a converging ProxDDP actually
    emits (Gauss-Newton quadratics + preg·I are PSD by construction,
    ``solver-proxddp.hxx:802``) and the operating domain of the pivot-free
    parallel-in-time kernel: partial minimization at a leg-terminal knot
    then yields a PSD leg value function, keeping every in-leg Schur
    complement SPD. ``random_problem``'s independent Q/R draws with a dense
    S can make the joint block indefinite — the serial sweep tolerates that
    (terminal padding keeps its recursion in the SPD domain on typical
    draws), but leg-split sweeps may not (the reference covers such draws
    with Bunch-Kaufman pivoting, ``gar/riccati-kernel.hxx``; its ProxDDP
    likewise convexifies via preg escalation when a factorization fails).
    """
    if nc0 is None:
        nc0 = nx
    base = random_problem(key, N, nx, nu, nc, nc0=nc0, dtype=dtype)
    kn = base.knots
    T = N + 1
    keys = jax.random.split(jax.random.fold_in(key, 1), T)
    joint = jax.vmap(
        lambda kk: random_wishart(kk, nx + nu, nx + nu + 2, dtype)
    )(keys)
    Q = joint[:, :nx, :nx]
    S = joint[:, :nx, nx:]
    R = joint[:, nx:, nx:] + 0.1 * jnp.eye(nu, dtype=dtype)
    # keep the terminal padding from random_problem: the terminal knot has
    # no control, so its S/R Wishart draw is discarded (S=0, R=I padding)
    # and the terminal Q is inherited from random_problem's nx-dim Wishart
    # rather than the (nx+nu)-dim joint draw above — a different (but still
    # PSD) distribution than the stage Qs, by design; only joint stage-block
    # convexity matters for the parallel-leg domain guarantee.
    Q = Q.at[N].set(kn.Q[N])
    S = S.at[N].set(0.0)
    R = R.at[N].set(jnp.eye(nu, dtype=dtype))
    from .._pytree import replace

    return replace(base, knots=replace(kn, Q=Q, S=S, R=R))


# ---------------------------------------------------------------------------
# Dense KKT assembly (test oracle) and KKT error
# ---------------------------------------------------------------------------


def _num_rows(problem: LQRProblem) -> int:
    N = problem.horizon
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    # λ0 + per stage (x,u,ν) + per transition λ_{t+1}
    return problem.nc0 + (N + 1) * (nx + nu + nc) + N * nx


def dense_kkt(problem: LQRProblem, mudyn, mueq):
    """Assemble the full (dense, symmetric) proximal KKT system ``M z = -rhs``.

    Variable layout: ``[λ0, (x0,u0,ν0), λ1, (x1,u1,ν1), ..., λN, (xN,uN,νN)]``
    matching the reference oracle ``lqrDenseMatrix``
    (``include/aligator/gar/utils.hxx:194``). Returns ``(M, rhs)``; the KKT
    solution solves ``M z + rhs = 0``.
    """
    kn = problem.knots
    N = problem.horizon
    nx, nu, nc, nc0 = problem.nx, problem.nu, problem.nc, problem.nc0
    n = nx + nu + nc
    nrows = _num_rows(problem)
    dt = kn.Q.dtype
    M = jnp.zeros((nrows, nrows), dt)
    rhs = jnp.zeros((nrows,), dt)

    # initial block
    M = M.at[:nc0, :nc0].set(-mudyn * jnp.eye(nc0, dtype=dt))
    M = M.at[:nc0, nc0 : nc0 + nx].set(problem.G0)
    M = M.at[nc0 : nc0 + nx, :nc0].set(problem.G0.T)
    rhs = rhs.at[:nc0].set(problem.g0)

    idx = nc0
    for t in range(N + 1):
        ix, iu, ic = idx, idx + nx, idx + nx + nu
        M = M.at[ix : ix + nx, ix : ix + nx].add(kn.Q[t])
        M = M.at[ix : ix + nx, iu : iu + nu].add(kn.S[t])
        M = M.at[iu : iu + nu, ix : ix + nx].add(kn.S[t].T)
        M = M.at[iu : iu + nu, iu : iu + nu].add(kn.R[t])
        M = M.at[ic : ic + nc, ix : ix + nx].add(kn.C[t])
        M = M.at[ix : ix + nx, ic : ic + nc].add(kn.C[t].T)
        M = M.at[ic : ic + nc, iu : iu + nu].add(kn.D[t])
        M = M.at[iu : iu + nu, ic : ic + nc].add(kn.D[t].T)
        M = M.at[ic : ic + nc, ic : ic + nc].add(-mueq * jnp.eye(nc, dtype=dt))
        rhs = rhs.at[ix : ix + nx].set(kn.q[t])
        rhs = rhs.at[iu : iu + nu].set(kn.r[t])
        rhs = rhs.at[ic : ic + nc].set(kn.d[t])

        if t < N:
            il = idx + n  # costate λ_{t+1} row block
            iy = il + nx  # x_{t+1} col block
            M = M.at[il : il + nx, ix : ix + nx].set(kn.A[t])
            M = M.at[ix : ix + nx, il : il + nx].set(kn.A[t].T)
            M = M.at[il : il + nx, iu : iu + nu].set(kn.B[t])
            M = M.at[iu : iu + nu, il : il + nx].set(kn.B[t].T)
            M = M.at[il : il + nx, il : il + nx].set(-mudyn * jnp.eye(nx, dtype=dt))
            M = M.at[il : il + nx, iy : iy + nx].set(kn.E[t])
            M = M.at[iy : iy + nx, il : il + nx].set(kn.E[t].T)
            rhs = rhs.at[il : il + nx].set(kn.f[t])
            idx += n + nx
    return M, rhs


def dense_solve(problem: LQRProblem, mudyn, mueq):
    """Solve the LQ problem by dense KKT factorization. Returns (xs, us, vs, lams).

    Reference-role: the CHOLMOD/dense baseline solver
    (``gar/cholmod-solver.hpp:14``) and the dense-assembly test oracle.
    """
    M, rhs = dense_kkt(problem, mudyn, mueq)
    z = jnp.linalg.solve(M, -rhs)
    return split_solution(problem, z)


def initialize_solution(problem: LQRProblem):
    """Zero-initialized ``(xs, us, vs, lams)`` with the problem's shapes
    (reference ``lqrInitializeSolution``, gar/utils.hpp)."""
    N = problem.horizon
    nx, nu, nc = problem.nx, problem.nu, problem.nc
    dt = problem.knots.Q.dtype
    return (
        jnp.zeros((N + 1, nx), dt),
        jnp.zeros((N + 1, nu), dt),
        jnp.zeros((N + 1, nc), dt),
        jnp.zeros((N + 1, nx), dt),
    )


def split_solution(problem: LQRProblem, z: jax.Array):
    """Split a stacked dense-KKT solution vector into (xs, us, vs, lams)."""
    N = problem.horizon
    nx, nu, nc, nc0 = problem.nx, problem.nu, problem.nc, problem.nc0
    n = nx + nu + nc
    xs, us, vs, lams = [], [], [], []
    lams.append(z[:nc0])
    idx = nc0
    for t in range(N + 1):
        xs.append(z[idx : idx + nx])
        us.append(z[idx + nx : idx + nx + nu])
        vs.append(z[idx + nx + nu : idx + n])
        if t < N:
            lams.append(z[idx + n : idx + n + nx])
            idx += n + nx
    return (
        jnp.stack(xs),
        jnp.stack(us),
        jnp.stack(vs),
        jnp.stack(lams),
    )


def kkt_error(
    problem: LQRProblem,
    xs: jax.Array,  # (N+1, nx)
    us: jax.Array,  # (N+1, nu)  (u_N present but padded)
    vs: jax.Array,  # (N+1, nc)
    lams: jax.Array,  # (N+1, nx) with lams[0] of size nc0 == nx assumed
    mudyn,
    mueq,
    theta: Optional[jax.Array] = None,
):
    """Max-norm KKT residuals ``(dyn, cstr, dual)`` of a candidate solution.

    Direct JAX re-expression of the reference oracle ``lqrComputeKktError``
    (``include/aligator/gar/utils.hxx:95``): plug (xs, us, vs, λs) back into
    the proximal stationarity conditions. Fully vectorized over stages.
    """
    kn = problem.knots
    N = problem.horizon

    # dynamics residuals
    d0 = problem.g0 + problem.G0 @ xs[0] - mudyn * lams[0]
    # t = 0..N-1: A x_t + B u_t + f + E x_{t+1} - mudyn λ_{t+1}
    dyn = (
        jnp.einsum("tij,tj->ti", kn.A[:N], xs[:N])
        + jnp.einsum("tij,tj->ti", kn.B[:N], us[:N])
        + kn.f[:N]
        + jnp.einsum("tij,tj->ti", kn.E[:N], xs[1:])
        - mudyn * lams[1:]
    )
    dyn_err = jnp.maximum(
        jnp.max(jnp.abs(d0)), jnp.max(jnp.abs(dyn)) if N > 0 else 0.0
    )

    # constraint residuals: C x + D u + d - mueq ν
    cstr = (
        jnp.einsum("tij,tj->ti", kn.C, xs)
        + jnp.einsum("tij,tj->ti", kn.D, us)
        + kn.d
        - mueq * vs
    )
    cstr_err = jnp.max(jnp.abs(cstr)) if cstr.size else jnp.asarray(0.0)

    # dual residuals
    gx = (
        kn.q
        + jnp.einsum("tij,tj->ti", kn.Q, xs)
        + jnp.einsum("tij,tj->ti", kn.S, us)
        + jnp.einsum("tji,tj->ti", kn.C, vs)
    )
    gu = (
        kn.r
        + jnp.einsum("tji,tj->ti", kn.S, xs)
        + jnp.einsum("tij,tj->ti", kn.R, us)
        + jnp.einsum("tji,tj->ti", kn.D, vs)
    )
    # costate coupling: t=0 gets G0'λ0; t>=1 gets E_{t-1}'λ_t; t<N adds A'λ_{t+1}, B'λ_{t+1}
    gx = gx.at[0].add(problem.G0.T @ lams[0])
    gx = gx.at[1:].add(jnp.einsum("tji,tj->ti", kn.E[:N], lams[1:]))
    gx = gx.at[:N].add(jnp.einsum("tji,tj->ti", kn.A[:N], lams[1:]))
    gu = gu.at[:N].add(jnp.einsum("tji,tj->ti", kn.B[:N], lams[1:]))

    if theta is not None and kn.nth > 0:
        gx = gx + jnp.einsum("tij,j->ti", kn.Gx, theta)
        gu = gu + jnp.einsum("tij,j->ti", kn.Gu, theta)

    dual_err = jnp.maximum(jnp.max(jnp.abs(gx)), jnp.max(jnp.abs(gu)))
    return dyn_err, cstr_err, dual_err


def kkt_residual_vectors(
    problem: LQRProblem, xs, us, vs, lams, mudyn, mueq
):
    """Full KKT residual VECTORS (not norms) of a candidate solution:
    returns (g0_res (nc0,), gx (T,nx), gu (T,nu), cstr (T,nc), dyn (N,nx)).

    Used by iterative refinement (:func:`solve_refined`) — the reference's
    refinement loops (``cholmod-solver``, ``parallel-solver.hxx:156-175``)
    play the same role.
    """
    kn = problem.knots
    N = problem.horizon

    g0_res = problem.g0 + problem.G0 @ xs[0] - mudyn * lams[0]
    dyn = (
        jnp.einsum("tij,tj->ti", kn.A[:N], xs[:N])
        + jnp.einsum("tij,tj->ti", kn.B[:N], us[:N])
        + kn.f[:N]
        + jnp.einsum("tij,tj->ti", kn.E[:N], xs[1:])
        - mudyn * lams[1:]
    )
    cstr = (
        jnp.einsum("tij,tj->ti", kn.C, xs)
        + jnp.einsum("tij,tj->ti", kn.D, us)
        + kn.d
        - mueq * vs
    )
    gx = (
        kn.q
        + jnp.einsum("tij,tj->ti", kn.Q, xs)
        + jnp.einsum("tij,tj->ti", kn.S, us)
        + jnp.einsum("tji,tj->ti", kn.C, vs)
    )
    gu = (
        kn.r
        + jnp.einsum("tji,tj->ti", kn.S, xs)
        + jnp.einsum("tij,tj->ti", kn.R, us)
        + jnp.einsum("tji,tj->ti", kn.D, vs)
    )
    gx = gx.at[0].add(problem.G0.T @ lams[0])
    gx = gx.at[1:].add(jnp.einsum("tji,tj->ti", kn.E[:N], lams[1:]))
    gx = gx.at[:N].add(jnp.einsum("tji,tj->ti", kn.A[:N], lams[1:]))
    gu = gu.at[:N].add(jnp.einsum("tji,tj->ti", kn.B[:N], lams[1:]))
    return g0_res, gx, gu, cstr, dyn
