"""Fused batched proximal Riccati solve as one Pallas kernel (Triton route).

The XLA scan path (gar/riccati.py + smallmat) runs the backward and forward
recursions as a ``while`` loop whose body is some 40-50 small operations per
stage; on a GPU each is its own kernel launch over ``(B, n, n)`` buffers.
This kernel runs the whole solve (terminal stage, backward sweep, initial
stage, forward sweep) in one launch:

* one scenario per lane: a program owns ``block`` scenarios, and every scalar
  entry of the small per-stage matrices is a ``(block,)`` vector. The linear
  algebra is statically unrolled scalar arithmetic (the closed forms of
  gar/smallmat.py), so each lane's Cholesky / Gauss-Jordan algebra stays in
  registers.
* layout ``(tiles, T, F, block)``: each per-stage field is one coalesced
  block-vector load.
* the value function ``(P, p)`` is a loop carry; the per-stage gains are an
  output in device memory, written by the backward loop and read back by the
  forward loop.
* μ is a per-lane vector: under a vmapped ProxDDP each scenario's
  augmented-Lagrangian loop evolves μ on its own.

Supports static ``(nx, nu, nc)`` with ``nc0 == nx`` and no θ-block; explicit
(``E = -I``) or general E (unrolled Gauss-Jordan inverse per stage). Callers
check :func:`covers` and fall back to the XLA path otherwise.

Feature packing (axis F), per stage t:
  Q (nx*nx) | S (nx*nu) | R (nu*nu) | q (nx) | r (nu) |
  A (nx*nx) | B (nx*nu) | f (nx) | C (nc*nx) | D (nc*nu) | d (nc) [| E]
plus a stage-independent block carrying G0 (nx*nx) and g0 (nx).
Outputs: xs (T,nx) | us (T,nu) | vs (T,nc) | lams (T,nx) packed the same way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .lqr_problem import LQRProblem

# Scenarios per program and warps per program: the fastest of seven
# (block, warps) pairs timed on an H100 at the SE(2) fleet's LQ shape (see
# PERF.md); both are powers of two, as Triton needs.
BLOCK = 32
NUM_WARPS = 1
# Largest nx and nu the unrolled kernel is built for. Its compile time grows
# faster than its operation count: on an H100 (nx=3, nu=2, nc=0) compiled in
# 28 s and (nx=4, nu=2, nc=2) in 169 s; nx=8 has about 8x the operations of
# nx=4 and was not compiled (see PERF.md).
MAX_DIM = 4


def covers(nx, nu, nc0, nth) -> bool:
    """Whether the kernel covers a problem of this structure (any batch)."""
    return nc0 == nx and nth == 0 and nx <= MAX_DIM and nu <= MAX_DIM


def _layout(sizes):
    offs, cur = {}, 0
    for k, v in sizes.items():
        offs[k] = cur
        cur += v
    return offs, cur


def _field_layout(nx, nu, nc, with_E=False):
    sizes = {
        "Q": nx * nx, "S": nx * nu, "R": nu * nu, "q": nx, "r": nu,
        "A": nx * nx, "B": nx * nu, "f": nx,
        "C": nc * nx, "D": nc * nu, "d": nc,
    }
    if with_E:
        sizes["E"] = nx * nx
    return _layout(sizes)


def _out_layout(nx, nu, nc):
    return _layout({"xs": nx, "us": nu, "vs": nc, "lams": nx})


def _gain_layout(nx, nu, nc):
    return _layout(dict(kff=nu, K=nu * nx, zff=nc, Z=nc * nx, lff=nx,
                        L=nx * nx, yff=nx, Afb=nx * nx))


# ---- scalar-lane linear algebra (lists of (block,) vectors) ----


def _chol(Mf, n):
    """Cholesky of an n×n matrix of lane-vectors (list-of-lists)."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Mf[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = Mf[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol_solve_vec(L, b, n):
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _matmul(Af, Bf, m, k, n, tA=False, tB=False):
    out = [[None] * n for _ in range(m)]
    for i in range(m):
        for j in range(n):
            s = None
            for l in range(k):
                a = Af[l][i] if tA else Af[i][l]
                b = Bf[j][l] if tB else Bf[l][j]
                s = a * b if s is None else s + a * b
            out[i][j] = s
    return out


def _matvec(Af, x, m, n, tA=False):
    out = [None] * m
    for i in range(m):
        s = None
        for j in range(n):
            a = Af[j][i] if tA else Af[i][j]
            s = a * x[j] if s is None else s + a * x[j]
        out[i] = s
    return out


def _inv(Mf, n):
    """Unrolled Gauss-Jordan inverse (no pivoting). Used for the dynamics
    E-blocks, which are ``-I + O(dt)`` perturbations of the identity (the
    manifold difference-chart Jacobian), hence strongly diagonally
    dominant — pivoting is unnecessary."""
    a = [[Mf[i][j] for j in range(n)] for i in range(n)]
    zero = Mf[0][0] * 0.0
    one = zero + 1.0
    inv = [[one if i == j else zero for j in range(n)] for i in range(n)]
    for k in range(n):
        piv = 1.0 / a[k][k]
        for j in range(n):
            a[k][j] = a[k][j] * piv
            inv[k][j] = inv[k][j] * piv
        for i in range(n):
            if i == k:
                continue
            fac = a[i][k]
            for j in range(n):
                a[i][j] = a[i][j] - fac * a[k][j]
                inv[i][j] = inv[i][j] - fac * inv[k][j]
    return inv


def _kernel(nx, nu, nc, T, explicit, mu_ref, in_ref, g_ref, out_ref,
            gains_ref):
    offs, _ = _field_layout(nx, nu, nc, with_E=not explicit)
    ooffs, _ = _out_layout(nx, nu, nc)
    goffs, _ = _gain_layout(nx, nu, nc)
    mudyn = mu_ref[0, :]
    mueq = mu_ref[1, :]
    inv_mueq = 1.0 / mueq
    inv_mudyn = 1.0 / mudyn

    def load_mat(t, name, m, n):
        base = offs[name]
        return [[in_ref[t, base + i * n + j, :] for j in range(n)]
                for i in range(m)]

    def load_vec(t, name, m):
        base = offs[name]
        return [in_ref[t, base + i, :] for i in range(m)]

    def store_gain_mat(t, name, Mf, m, n):
        base = goffs[name]
        for i in range(m):
            for j in range(n):
                gains_ref[t, base + i * n + j, :] = Mf[i][j]

    def store_gain_vec(t, name, x, m):
        base = goffs[name]
        for i in range(m):
            gains_ref[t, base + i, :] = x[i]

    def reduced_kkt(Rhat, Ct, Dt, dt_, rhat, ShatT):
        # W = Rhat + D'D/mueq
        W = [[Rhat[i][j] for j in range(nu)] for i in range(nu)]
        for i in range(nu):
            for j in range(nu):
                for k in range(nc):
                    W[i][j] = W[i][j] + Dt[k][i] * Dt[k][j] * inv_mueq
        Lw = _chol(W, nu)
        # kff = -W^{-1}(rhat + D'd/mueq)
        b = []
        for i in range(nu):
            s = rhat[i]
            for k in range(nc):
                s = s + Dt[k][i] * dt_[k] * inv_mueq
            b.append(-s)
        kff = _chol_solve_vec(Lw, b, nu)
        # K = -W^{-1}(Shat' + D'C/mueq)  column by column
        K = [[None] * nx for _ in range(nu)]
        for j in range(nx):
            col = []
            for i in range(nu):
                s = ShatT[i][j]
                for k in range(nc):
                    s = s + Dt[k][i] * Ct[k][j] * inv_mueq
                col.append(-s)
            sol = _chol_solve_vec(Lw, col, nu)
            for i in range(nu):
                K[i][j] = sol[i]
        # zff = (D kff + d)/mueq ; Z = (D K + C)/mueq
        zff = []
        Z = [[None] * nx for _ in range(nc)]
        for k in range(nc):
            s = dt_[k]
            for i in range(nu):
                s = s + Dt[k][i] * kff[i]
            zff.append(s * inv_mueq)
            for j in range(nx):
                z = Ct[k][j]
                for i in range(nu):
                    z = z + Dt[k][i] * K[i][j]
                Z[k][j] = z * inv_mueq
        return kff, K, zff, Z

    # ---------------- terminal stage ----------------
    t = T - 1
    Qm = load_mat(t, "Q", nx, nx)
    Sm = load_mat(t, "S", nx, nu)
    Rm = load_mat(t, "R", nu, nu)
    qv = load_vec(t, "q", nx)
    rv = load_vec(t, "r", nu)
    Cm = load_mat(t, "C", nc, nx)
    Dm = load_mat(t, "D", nc, nu)
    dv = load_vec(t, "d", nc)
    St = [[Sm[j][i] for j in range(nx)] for i in range(nu)]
    kff, K, zff, Z = reduced_kkt(Rm, Cm, Dm, dv, rv, St)
    # P = Q + C'Z + S K ; p = q + C'zff + S kff
    P0, p0 = [], []
    for i in range(nx):
        for j in range(nx):
            s = Qm[i][j]
            for k in range(nc):
                s = s + Cm[k][i] * Z[k][j]
            for k in range(nu):
                s = s + Sm[i][k] * K[k][j]
            P0.append(s)
        s = qv[i]
        for k in range(nc):
            s = s + Cm[k][i] * zff[k]
        for k in range(nu):
            s = s + Sm[i][k] * kff[k]
        p0.append(s)
    store_gain_vec(t, "kff", kff, nu)
    store_gain_mat(t, "K", K, nu, nx)
    store_gain_vec(t, "zff", zff, nc)
    store_gain_mat(t, "Z", Z, nc, nx)
    # the terminal stage has no dynamics: its propagation gains are zero,
    # as on the scan path
    zvec = [jnp.zeros_like(mudyn)] * nx
    zmat = [zvec] * nx
    store_gain_vec(t, "lff", zvec, nx)
    store_gain_mat(t, "L", zmat, nx, nx)
    store_gain_vec(t, "yff", zvec, nx)
    store_gain_mat(t, "Afb", zmat, nx, nx)

    # ---------------- backward sweep ----------------
    # the value function (P, p) is the loop carry: nx*nx + nx lane vectors
    def bwd_body(i, carry):
        Pflat, pv = carry
        t = T - 2 - i
        P = [[Pflat[a * nx + b_] for b_ in range(nx)] for a in range(nx)]
        if explicit:
            # E = -I: Ptilde = P, ptilde = p
            Pt, pt = P, list(pv)
            Einv = None
        else:
            # general E: Ptilde = E^{-T} P E^{-1}, ptilde = -E^{-T} p
            Em = load_mat(t, "E", nx, nx)
            Einv = _inv(Em, nx)
            PE = _matmul(P, Einv, nx, nx, nx)
            Pt = _matmul(Einv, PE, nx, nx, nx, tA=True)
            for a in range(nx):
                for b_ in range(a + 1, nx):
                    m = 0.5 * (Pt[a][b_] + Pt[b_][a])
                    Pt[a][b_] = m
                    Pt[b_][a] = m
            pt = [-s for s in _matvec(Einv, pv, nx, nx, tA=True)]
        # schur = I + mudyn Ptilde ; solve
        Sc = [[Pt[a][b_] * mudyn for b_ in range(nx)] for a in range(nx)]
        for a in range(nx):
            Sc[a][a] = Sc[a][a] + 1.0
        Ls = _chol(Sc, nx)
        fvec = load_vec(t, "f", nx)
        # vx = schur^{-1}(ptilde + Ptilde f) ; Vxx = schur^{-1} Ptilde
        rhs = []
        for a in range(nx):
            s = pt[a]
            for b_ in range(nx):
                s = s + Pt[a][b_] * fvec[b_]
            rhs.append(s)
        vx = _chol_solve_vec(Ls, rhs, nx)
        Vxx = [[None] * nx for _ in range(nx)]
        for j in range(nx):
            col = [Pt[a][j] for a in range(nx)]
            sol = _chol_solve_vec(Ls, col, nx)
            for a in range(nx):
                Vxx[a][j] = sol[a]
        # symmetrize Vxx
        for a in range(nx):
            for b_ in range(a + 1, nx):
                m = 0.5 * (Vxx[a][b_] + Vxx[b_][a])
                Vxx[a][b_] = m
                Vxx[b_][a] = m

        Am = load_mat(t, "A", nx, nx)
        Bm = load_mat(t, "B", nx, nu)
        Qm = load_mat(t, "Q", nx, nx)
        Sm = load_mat(t, "S", nx, nu)
        Rm = load_mat(t, "R", nu, nu)
        qv = load_vec(t, "q", nx)
        rv = load_vec(t, "r", nu)
        Cm = load_mat(t, "C", nc, nx)
        Dm = load_mat(t, "D", nc, nu)
        dv = load_vec(t, "d", nc)

        AtV = _matmul(Am, Vxx, nx, nx, nx, tA=True)  # A'Vxx
        BtV = _matmul(Bm, Vxx, nu, nx, nx, tA=True)  # B'Vxx
        Qhat = _matmul(AtV, Am, nx, nx, nx)
        for a in range(nx):
            for b_ in range(nx):
                Qhat[a][b_] = Qhat[a][b_] + Qm[a][b_]
        Rhat = _matmul(BtV, Bm, nu, nx, nu)
        for a in range(nu):
            for b_ in range(nu):
                Rhat[a][b_] = Rhat[a][b_] + Rm[a][b_]
        ShatT = _matmul(BtV, Am, nu, nx, nx)  # B'Vxx A + S'
        for a in range(nu):
            for b_ in range(nx):
                ShatT[a][b_] = ShatT[a][b_] + Sm[b_][a]
        qhat = _matvec(Am, vx, nx, nx, tA=True)
        for a in range(nx):
            qhat[a] = qhat[a] + qv[a]
        rhat = _matvec(Bm, vx, nu, nx, tA=True)
        for a in range(nu):
            rhat[a] = rhat[a] + rv[a]

        kff, K, zff, Z = reduced_kkt(Rhat, Cm, Dm, dv, rhat, ShatT)

        # lff = vx + Vxx B kff ; L = Vxx A + Vxx B K
        Bk = _matvec(Bm, kff, nx, nu)
        VxxBk = _matvec(Vxx, Bk, nx, nx)
        lff = [vx[a] + VxxBk[a] for a in range(nx)]
        BK = _matmul(Bm, K, nx, nu, nx)
        ApBK = [[Am[a][b_] + BK[a][b_] for b_ in range(nx)] for a in range(nx)]
        L = _matmul(Vxx, ApBK, nx, nx, nx)
        ytil = [fvec[a] + Bk[a] - mudyn * lff[a] for a in range(nx)]
        Atil = [
            [ApBK[a][b_] - mudyn * L[a][b_] for b_ in range(nx)]
            for a in range(nx)
        ]
        if explicit:
            # E = -I: yff = f + B kff - mudyn lff ; Afb = A + BK - mudyn L
            yff, Afb = ytil, Atil
        else:
            # yff = -E^{-1} ytil ; Afb = -E^{-1} Atil
            yff = [-s for s in _matvec(Einv, ytil, nx, nx)]
            EA = _matmul(Einv, Atil, nx, nx, nx)
            Afb = [[-EA[a][b_] for b_ in range(nx)] for a in range(nx)]

        # value recursion
        ShK = _matmul(ShatT, K, nx, nu, nx, tA=True)  # Shat K  (Shat = ShatT')
        newP = [[None] * nx for _ in range(nx)]
        for a in range(nx):
            for b_ in range(nx):
                s = Qhat[a][b_] + ShK[a][b_]
                for k in range(nc):
                    s = s + Cm[k][a] * Z[k][b_]
                newP[a][b_] = s
        newp = [None] * nx
        for a in range(nx):
            s = qhat[a]
            for k in range(nu):
                s = s + ShatT[k][a] * kff[k]
            for k in range(nc):
                s = s + Cm[k][a] * zff[k]
            newp[a] = s

        store_gain_vec(t, "kff", kff, nu)
        store_gain_mat(t, "K", K, nu, nx)
        store_gain_vec(t, "zff", zff, nc)
        store_gain_mat(t, "Z", Z, nc, nx)
        store_gain_vec(t, "lff", lff, nx)
        store_gain_mat(t, "L", L, nx, nx)
        store_gain_vec(t, "yff", yff, nx)
        store_gain_mat(t, "Afb", Afb, nx, nx)
        Pflat = [0.5 * (newP[a][b_] + newP[b_][a])
                 for a in range(nx) for b_ in range(nx)]
        return Pflat, newp

    Pflat, pv = lax.fori_loop(0, T - 1, bwd_body, (P0, p0))

    # ---------------- initial stage ----------------
    G0 = [[g_ref[i * nx + j, :] for j in range(nx)] for i in range(nx)]
    g0 = [g_ref[nx * nx + i, :] for i in range(nx)]
    W = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        for j in range(nx):
            s = Pflat[i * nx + j]
            for k in range(nx):
                s = s + G0[k][i] * G0[k][j] * inv_mudyn
            W[i][j] = s
    Lw = _chol(W, nx)
    b = []
    for i in range(nx):
        s = pv[i]
        for k in range(nx):
            s = s + G0[k][i] * g0[k] * inv_mudyn
        b.append(-s)
    x0 = _chol_solve_vec(Lw, b, nx)
    for i in range(nx):
        s = g0[i]
        for j in range(nx):
            s = s + G0[i][j] * x0[j]
        out_ref[0, ooffs["lams"] + i, :] = s * inv_mudyn

    # ---------------- forward sweep ----------------
    def gain(t, name, i):
        return gains_ref[t, goffs[name] + i, :]

    def controls(t, x):
        for i in range(nx):
            out_ref[t, ooffs["xs"] + i, :] = x[i]
        for i in range(nu):
            s = gain(t, "kff", i)
            for j in range(nx):
                s = s + gain(t, "K", i * nx + j) * x[j]
            out_ref[t, ooffs["us"] + i, :] = s
        for k in range(nc):
            s = gain(t, "zff", k)
            for j in range(nx):
                s = s + gain(t, "Z", k * nx + j) * x[j]
            out_ref[t, ooffs["vs"] + k, :] = s

    def fwd_body(t, x):
        controls(t, x)
        for i in range(nx):
            s = gain(t, "lff", i)
            for j in range(nx):
                s = s + gain(t, "L", i * nx + j) * x[j]
            out_ref[t + 1, ooffs["lams"] + i, :] = s
        x_next = []
        for i in range(nx):
            s = gain(t, "yff", i)
            for j in range(nx):
                s = s + gain(t, "Afb", i * nx + j) * x[j]
            x_next.append(s)
        return x_next

    xN = lax.fori_loop(0, T - 1, fwd_body, x0)
    controls(T - 1, xN)


def solve(problem: LQRProblem, mudyn, mueq, interpret=False,
          return_gains=False, assume_explicit=True):
    """Batched fused solve. ``problem`` leaves carry a leading batch axis
    (vmap-style stacking) whose size is a multiple of ``BLOCK``.

    Returns ``(xs, us, vs, lams)`` with leading batch axis; with
    ``return_gains=True`` additionally a dict of per-stage gain arrays
    ``kff (B,T,nu) | K (B,T,nu,nx) | zff | Z | lff | L | yff | Afb`` (what
    ProxDDP's forward passes and MPC feedback consume). ``mudyn``/``mueq``
    may be traced, and either scalars or per-problem ``(B,)`` vectors; they
    enter the kernel as lane vectors. ``interpret`` runs the kernel in
    the Pallas interpreter (CPU tests).
    """
    kn = problem.knots
    nx, nu, nc = kn.nx, kn.nu, kn.nc
    Bsz = kn.Q.shape[0]
    T = kn.Q.shape[1]
    dt = kn.Q.dtype
    block = BLOCK
    if Bsz % block != 0:
        raise ValueError(f"batch {Bsz} must be a multiple of {block}")

    _, F = _field_layout(nx, nu, nc, with_E=not assume_explicit)
    ooffs, OF = _out_layout(nx, nu, nc)
    goffs, GF = _gain_layout(nx, nu, nc)

    blocks = [
        kn.Q, kn.S, kn.R, kn.q, kn.r, kn.A, kn.B, kn.f, kn.C, kn.D, kn.d,
    ]
    if not assume_explicit:
        blocks.append(kn.E)
    feats = jnp.concatenate([a.reshape(Bsz, T, -1) for a in blocks], axis=-1)
    assert feats.shape[-1] == F
    g0feats = jnp.concatenate(
        [problem.G0.reshape(Bsz, nx * nx), problem.g0.reshape(Bsz, nx)],
        axis=-1,
    )  # (B, nx*nx + nx)

    # (B, T, F) → (tiles, T, F, block): a field of one stage is one
    # contiguous block-vector
    tiles = Bsz // block
    feats = feats.reshape(tiles, block, T, F).transpose(0, 2, 3, 1)
    g0feats = g0feats.reshape(tiles, block, nx * nx + nx).transpose(0, 2, 1)
    mu_arr = jnp.stack(
        [
            jnp.broadcast_to(jnp.asarray(mudyn, dt), (Bsz,)),
            jnp.broadcast_to(jnp.asarray(mueq, dt), (Bsz,)),
        ],
        axis=-1,
    )
    mu_arr = mu_arr.reshape(tiles, block, 2).transpose(0, 2, 1)

    kern = functools.partial(_kernel, nx, nu, nc, T, bool(assume_explicit))

    def spec(*shape):
        return pl.BlockSpec((None,) + shape + (block,),
                            lambda i: (i,) + (0,) * (len(shape) + 1))

    out, gains = pl.pallas_call(
        kern,
        grid=(tiles,),
        in_specs=[spec(2), spec(T, F), spec(nx * nx + nx)],
        out_specs=(spec(T, OF), spec(T, GF)),
        out_shape=(
            jax.ShapeDtypeStruct((tiles, T, OF, block), dt),
            jax.ShapeDtypeStruct((tiles, T, GF, block), dt),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="riccati_fused",
    )(mu_arr, feats, g0feats)

    out = out.transpose(0, 3, 1, 2).reshape(Bsz, T, OF)
    xs = out[..., ooffs["xs"] : ooffs["xs"] + nx]
    us = out[..., ooffs["us"] : ooffs["us"] + nu]
    vs = out[..., ooffs["vs"] : ooffs["vs"] + nc]
    lams = out[..., ooffs["lams"] : ooffs["lams"] + nx]
    if not return_gains:
        return xs, us, vs, lams

    g = gains.transpose(0, 3, 1, 2).reshape(Bsz, T, GF)

    def unpack(name, m, n=None):
        base = goffs[name]
        sz = m if n is None else m * n
        blk = g[..., base : base + sz]
        return blk if n is None else blk.reshape(Bsz, T, m, n)

    gain_arrays = dict(
        kff=unpack("kff", nu), K=unpack("K", nu, nx),
        zff=unpack("zff", nc), Z=unpack("Z", nc, nx),
        lff=unpack("lff", nx), L=unpack("L", nx, nx),
        yff=unpack("yff", nx), Afb=unpack("Afb", nx, nx),
    )
    return xs, us, vs, lams, gain_arrays
