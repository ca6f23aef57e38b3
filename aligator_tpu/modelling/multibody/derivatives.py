"""Analytic rigid-body dynamics derivatives (world-frame einsum form).

Accelerator-native counterpart of Pinocchio's analytic derivative algorithms that
the reference rides for its hot path: ``pinocchio::computeABADerivatives``
(used by ``modelling/dynamics/multibody-free-fwd.hxx:66``) and
``computeConstraintDynamicsDerivatives``
(``modelling/dynamics/multibody-constraint-fwd.hxx:60``).

The engine (``model.py``) computes RNEA/CRBA as dense contractions over a
static ancestor mask instead of joint recursions; the same trick applies to
the *derivatives*.  With all spatial quantities expressed at the world
origin, the directional derivatives of the world dof axes, body velocities
and spatial inertias under a right-perturbation ``q ⊕ δ e_j`` are closed
cross-product forms:

    ∂S_k/∂q_j  = D[k,j] · S_j ×ₘ S_k              (axis transport)
    ∂V_b/∂q_j  = A[b,j] · S_j ×ₘ (V_b − V_{π(j)})  (telescoped dof sum)
    ∂I_b/∂q_j  = A[b,j] · (S_j ×* I_b − I_b S_j ×) (inertia transport)

where ``A (nbody,nv)`` is the body/dof ancestor mask, ``D (nv,nv)`` the
dof/dof ancestor mask and ``π(j)`` the parent body of dof j's joint.  All
dtau/dq, dtau/dv entries then follow by the product rule as (nv,nv,6) /
(nv,nbody,6) einsums — no per-joint recursion, no re-execution of the FK
scan, and (critically) no autodiff through Cholesky factorizations.  The
free and constrained forward-dynamics derivatives reuse the primal
factorizations (mass matrix and Delassus/KKT Schur complements) as
multi-RHS solves, exactly like the reference's analytic path.

Round-3 measurement being attacked here: the 78-tangent ``jacfwd`` through
``constrained_fwd_dynamics`` was 55% of a Talos-walk iteration
(``bench_talos.py --profile``).  Autodiff remains the *test oracle*
(``tests/test_rbd_derivatives.py`` checks every function against ``jacfwd``
in fp64).

Conventions: spatial vectors are (linear, angular) 6-vectors at the world
origin; tangent coordinates are the manifold's local (right) convention —
body twists for free-flyers, matching ``spaces/se3.py``.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.custom_derivatives import SymbolicZero

from ..._precision import highest_precision
from ..spaces.se3 import _hat
from . import model as rbd
from .model import (
    inertia_apply,
    motion_cross,
    motion_cross_force,
    _topology,
    _world_inertia,
)


# ---------------------------------------------------------------------------
# spatial operators
# ---------------------------------------------------------------------------


def cross_motion_matrix(S):
    """(…,6) motion vector → (…,6,6) matrix of m ↦ S ×ₘ m, ordering
    (linear, angular): [[ŵ, v̂], [0, ŵ]]."""
    v, w = S[..., :3], S[..., 3:]
    hw, hv = _hat(w), _hat(v)
    z = jnp.zeros_like(hw)
    top = jnp.concatenate([hw, hv], axis=-1)
    bot = jnp.concatenate([z, hw], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def cross_force_matrix(S):
    """(…,6) motion vector → (…,6,6) matrix of f ↦ S ×* f:
    [[ŵ, 0], [v̂, ŵ]] = −(S ×ₘ)ᵀ."""
    return -jnp.swapaxes(cross_motion_matrix(S), -1, -2)


def spatial_inertia6(m, c, I_c):
    """Explicit 6×6 spatial inertia at the world origin from the
    (mass, world com, world-rotated I about com) parameterization used by
    :func:`model.inertia_apply`.  Momentum (p, L) of motion (v, w):
    p = m v − m ĉ w,  L = m ĉ v + (I_c − m ĉ ĉ) w.  Broadcasts over
    leading axes."""
    chat = _hat(c)
    dt = chat.dtype
    eye3 = jnp.eye(3, dtype=dt)
    mI = m[..., None, None] * eye3
    mchat = m[..., None, None] * chat
    top = jnp.concatenate([mI, -mchat], axis=-1)
    bot = jnp.concatenate([mchat, I_c - mchat @ chat], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# derivative tensor pass
# ---------------------------------------------------------------------------


def _dof_tables(model):
    """Static per-dof tables: D (nv,nv) dof/dof ancestor-or-self mask
    (D[k,j] = 1 iff dof j's joint ⪯ dof k's joint) and π (nv,) parent-body
    index of each dof's joint (−1 = world)."""
    top = _topology(model.joint_types, model.parents)
    dj = top["dof_joint"]
    D = top["A"][dj, :]  # A[b, j] = anc[b, joint(j)] → rows at dof bodies
    pb = top["parents"][dj]
    return top, dj, D, pb


def rnea_tensors(model, q, v, a, fext=None, kin=None):
    """The shared derivative tensor pass.

    Returns a dict with the primal kinematic/dynamic quantities and the
    directional-derivative tensors indexed ``[j, …]`` over the nv tangent
    directions:

      S (nv,6), Vb/Accb (nb,6), I6 (nb,6,6), f (nb,6), F (nv,6),
      dV/dAcc (nv,nb,6) — q-direction derivative tensors,
      dVv/dAccv (nv,nb,6) — v-direction derivative tensors,
      dtau_dq, dtau_dv (nv,nv) — rows = τ component, cols = tangent dir
      (the per-body force derivatives df/dfv are contracted into
      dtau_dq/dtau_dv and not returned).

    ``fext``: optional (nb,6) external spatial forces in each joint's LOCAL
    frame (body-fixed under perturbation), as :func:`model.rnea`.
    """
    dt = q.dtype
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    top, dj, D_np, pb_np = _dof_tables(model)
    nv = int(top["nv"])
    A = kin["A"]  # (nb, nv)
    S = kin["Phi"]  # (nv, 6)
    Vb = kin["V"]  # (nb, 6)
    R, p = kin["R"], kin["p"]
    D = jnp.asarray(D_np, dt)
    Dt = D.T  # [j, k]
    At = A.T  # (nv, nb)
    maskjb = At[:, :, None]  # (nv, nb, 1)

    pb_safe = np.maximum(pb_np, 0)
    has_par = jnp.asarray((pb_np >= 0).astype(np.float64), dt)[:, None]
    Vpar = Vb[pb_safe] * has_par  # (nv, 6) V_{π(j)}
    Vdof = Vb[dj]  # (nv, 6) V_{B(k)}

    # primal acceleration pieces
    Ca = (A * a) @ S  # (nb,6) joint-acc part
    Capar = Ca[pb_safe] * has_par  # (nv,6)
    beta = motion_cross(Vdof, S * v[:, None])  # (nv,6)
    a_grav = jnp.concatenate([-model.gravity.astype(dt), jnp.zeros(3, dt)])
    Accb = Ca + A @ beta + a_grav  # (nb,6) incl. gravity offset

    # ∂S_k/∂q_j = D[k,j] S_j ×ₘ S_k  (unmasked pair table [j,k])
    SxS = motion_cross(S[:, None, :], S[None, :, :])  # (nv,nv,6)

    # ∂V_b/∂q_j
    dV = maskjb * motion_cross(
        S[:, None, :], Vb[None, :, :] - Vpar[:, None, :]
    )  # (nv,nb,6)

    # ∂Acc_b/∂q_j: joint-acc transport + β product-rule terms
    dAcc = maskjb * motion_cross(
        S[:, None, :], Ca[None, :, :] - Capar[:, None, :]
    )
    X1 = motion_cross(
        S[:, None, :], Vdof[None, :, :] - Vpar[:, None, :]
    )  # [j,k] = S_j × (V_B(k) − V_π(j))
    Sv = S * v[:, None]
    X2 = motion_cross(X1, Sv[None, :, :])
    X3 = motion_cross(
        jnp.broadcast_to(Vdof[None, :, :], X1.shape), SxS * v[None, :, None]
    )
    G = Dt[:, :, None] * (X2 + X3)  # (nv,nv,6) = Σ dβ_k/dq_j masked
    dAcc = dAcc + jnp.einsum("bk,jks->jbs", A, G)

    # ∂V_b/∂v_j and ∂Acc_b/∂v_j
    dVv = maskjb * S[:, None, :]
    Gv = Dt[:, :, None] * SxS * v[None, :, None] + jnp.eye(nv, dtype=dt)[
        :, :, None
    ] * motion_cross(Vdof, S)[None, :, :]
    dAccv = jnp.einsum("bk,jks->jbs", A, Gv)

    # forces and their derivatives
    m_w, c_w, I_w = _world_inertia(model, R, p, dt)
    I6 = spatial_inertia6(m_w, c_w, I_w)  # (nb,6,6)
    h = inertia_apply(m_w, c_w, I_w, Vb)  # I6 @ Vb
    f = inertia_apply(m_w, c_w, I_w, Accb) + motion_cross_force(Vb, h)

    cmS = cross_motion_matrix(S)  # (nv,6,6)
    cfS = -jnp.swapaxes(cmS, -1, -2)
    # dI6[j,b] = A[b,j] (cf(S_j) I6_b − I6_b cm(S_j))
    dI6 = maskjb[..., None] * (
        jnp.einsum("jst,btu->jbsu", cfS, I6)
        - jnp.einsum("bst,jtu->jbsu", I6, cmS)
    )

    if fext is not None:
        fl_w = jnp.einsum("nij,nj->ni", R, fext[:, :3])
        tau_w = jnp.einsum("nij,nj->ni", R, fext[:, 3:]) + jnp.cross(p, fl_w)
        fxw = jnp.concatenate([fl_w, tau_w], axis=1)  # (nb,6)
        f = f - fxw
        dfxw = maskjb * motion_cross_force(S[:, None, :], fxw[None, :, :])
    else:
        dfxw = None

    df = (
        jnp.einsum("jbsu,bu->jbs", dI6, Accb)
        + jnp.einsum("bsu,jbu->jbs", I6, dAcc)
        + motion_cross_force(dV, h[None, :, :])
        + motion_cross_force(
            Vb[None, :, :],
            jnp.einsum("jbsu,bu->jbs", dI6, Vb)
            + jnp.einsum("bsu,jbu->jbs", I6, dV),
        )
    )
    if dfxw is not None:
        df = df - dfxw

    dfv = (
        jnp.einsum("bsu,jbu->jbs", I6, dAccv)
        + motion_cross_force(dVv, h[None, :, :])
        + motion_cross_force(
            Vb[None, :, :], jnp.einsum("bsu,jbu->jbs", I6, dVv)
        )
    )

    # subtree force sums and τ derivatives
    F = jnp.einsum("bk,bs->ks", A, f)  # (nv,6)
    dtau_dq = D * jnp.einsum("jks,ks->jk", SxS, F).T + jnp.einsum(
        "bk,jbs,ks->kj", A, df, S
    )
    dtau_dv = jnp.einsum("bk,jbs,ks->kj", A, dfv, S)

    return {
        "kin": kin,
        "S": S,
        "Vb": Vb,
        "Accb": Accb,
        "I6": I6,
        "f": f,
        "F": F,
        "dV": dV,
        "dAcc": dAcc,
        "dVv": dVv,
        "dAccv": dAccv,
        "dtau_dq": dtau_dq,
        "dtau_dv": dtau_dv,
        "A": A,
        "D": D,
        "SxS": SxS,
    }


def rnea_derivatives(model, q, v, a, fext=None, kin=None):
    """Analytic ∂τ/∂q (local tangent coords) and ∂τ/∂v of
    ``rnea(model, q, v, a, fext)``, each (nv, nv) with rows the τ
    component and columns the tangent direction.  ∂τ/∂a is the mass matrix
    (``model.mass_matrix``).  Counterpart of
    ``pinocchio::computeRNEADerivatives`` (reference hot path via
    ``multibody-free-fwd.hxx:66``)."""
    t = rnea_tensors(model, q, v, a, fext=fext, kin=kin)
    return t["dtau_dq"], t["dtau_dv"]


# ---------------------------------------------------------------------------
# free forward dynamics (ABA role)
# ---------------------------------------------------------------------------


def aba_derivatives(model, q, v, tau, fext=None):
    """Analytic derivatives of ``a = aba(model, q, v, tau, fext)``.

    Returns ``(a, da_dq, da_dv, solve_M)`` with da_dτ = M⁻¹ applied by
    ``solve_M``.  Uses the inverse-dynamics identity
    ∂a/∂θ = −M⁻¹ ∂RNEA/∂θ |_{a=a*} (Carpentier-Mansard trick; the
    reference's ``computeABADerivatives`` role), reusing one Cholesky of M
    for all right-hand sides."""
    pack = _aba_deriv_pack(model, q, v, tau, fext)
    return pack["a"], pack["da_dq"], pack["da_dv"], pack["solve_M"]


def _aba_deriv_pack(model, q, v, tau, fext=None):
    from ...gar import smallmat

    dt = q.dtype
    kin = rbd.kinematics(model, q, v)
    kin["vdof"] = v
    b = rbd.rnea(model, q, v, jnp.zeros((model.nv,), dt), fext, kin=kin)
    M = rbd.mass_matrix(model, q, kin=kin)
    solve_M = smallmat.spd_solver(M)
    a = solve_M(tau - b)
    dtau_dq, dtau_dv = rnea_derivatives(model, q, v, a, fext=fext, kin=kin)
    return {
        "a": a,
        "da_dq": -solve_M(dtau_dq),
        "da_dv": -solve_M(dtau_dv),
        "solve_M": solve_M,
        "kin": kin,
    }


# ---------------------------------------------------------------------------
# constrained (contact) forward dynamics
# ---------------------------------------------------------------------------


def _point_derivative_rows(kin, tensors, body, p_c, dim, kp, kd, has_prefs,
                           dtype):
    """Directional derivatives of the contact-acceleration rows
    ``J a + γ + corr`` for one contact (body, world point p_c):
    returns (rows_q (dim,nv), rows_v (dim,nv), dp (nv,3)).  The linear rows
    are the material-point classical acceleration α = Acc_lin + Acc_ang×p
    + ω×ṗ; the angular rows (6D) are Acc_ang — differentiated with the
    dV/dAcc tensors (the constant gravity offset cancels: it is purely
    linear and only primal *angular* acceleration enters product terms)."""
    S = tensors["S"]
    Vb, Accb = tensors["Vb"], tensors["Accb"]
    A = tensors["A"]
    dV, dAcc = tensors["dV"], tensors["dAcc"]
    dVv, dAccv = tensors["dVv"], tensors["dAccv"]

    ab = A[body]  # (nv,)
    omega, VL = Vb[body, 3:], Vb[body, :3]
    AccA = Accb[body, 3:]
    pdot = VL + jnp.cross(omega, p_c)

    dp = ab[:, None] * (S[:, :3] + jnp.cross(S[:, 3:], p_c[None, :]))
    dom, dVL = dV[:, body, 3:], dV[:, body, :3]
    dAccL, dAccA = dAcc[:, body, :3], dAcc[:, body, 3:]
    dpdot = dVL + jnp.cross(dom, p_c[None, :]) + jnp.cross(omega[None, :], dp)
    dalpha_q = (
        dAccL
        + jnp.cross(dAccA, p_c[None, :])
        + jnp.cross(AccA[None, :], dp)
        + jnp.cross(dom, pdot[None, :])
        + jnp.cross(omega[None, :], dpdot)
    )

    domv, dVLv = dVv[:, body, 3:], dVv[:, body, :3]
    dAccLv, dAccAv = dAccv[:, body, :3], dAccv[:, body, 3:]
    dpdotv = dVLv + jnp.cross(domv, p_c[None, :])
    dalpha_v = (
        dAccLv
        + jnp.cross(dAccAv, p_c[None, :])
        + jnp.cross(domv, pdot[None, :])
        + jnp.cross(omega[None, :], dpdotv)
    )

    lin_q = dalpha_q + kd * dpdot + (kp * dp if has_prefs else 0.0)
    lin_v = dalpha_v + kd * dpdotv
    if dim == 3:
        return lin_q.T, lin_v.T, dp
    ang_q = dAccA + kd * dom
    ang_v = dAccAv + kd * domv
    rows_q = jnp.concatenate([lin_q.T, ang_q.T], axis=0)
    rows_v = jnp.concatenate([lin_v.T, ang_v.T], axis=0)
    return rows_q, rows_v, dp


def _fd_rows_std(model, q, v, a, lam, active, prefs,
                 contact_frames, contact_dims, kp, kd, has_prefs):
    """Reference jnp implementation of the derivative-rows pass: tensor
    pass + per-contact acceleration rows + Jᵀλ transport.  Returns
    ``(ra1_q, ra1_v, r2_q, r2_v)``.  Per-instance (unbatched); batched
    callers vmap it."""
    from . import contact as _contact

    dtype = q.dtype
    kin = rbd.kinematics(model, q, v)
    tensors = rnea_tensors(model, q, v, a, kin=kin)
    S, A, D, SxS = tensors["S"], tensors["A"], tensors["D"], tensors["SxS"]

    nv = model.nv
    dJtl_q = jnp.zeros((nv, nv), dtype)
    rows_q, rows_v = [], []
    offs = _contact.contact_offsets(contact_dims)
    for k, fid in enumerate(contact_frames):
        dim = contact_dims[k]
        body = model.frame_parents[fid]
        _, p_c = rbd.frame_placement(model, q, fid, kin=kin)
        rq, rv, dp = _point_derivative_rows(
            kin, tensors, body, p_c, dim, kp, kd, has_prefs, dtype
        )
        act_k = active[k]
        rows_q.append(rq * act_k)
        rows_v.append(rv * act_k)
        # contact generalized-force derivative ∂q(Jᵀλ) at fixed world
        # wrench: axis transport + moment-arm motion of the application
        # point (λ is world-fixed, unlike rnea's body-fixed fext)
        w_f = lam[offs[k] : offs[k] + 3]
        w_tau = (
            lam[offs[k] + 3 : offs[k] + 6]
            if dim == 6
            else jnp.zeros(3, dtype)
        )
        F_c = jnp.concatenate([w_f, jnp.cross(p_c, w_f) + w_tau])
        s1 = jnp.einsum("jks,s->jk", SxS, F_c)  # [j,k]
        term1 = A[body][:, None] * (D * s1.T)
        dpxw = jnp.cross(dp, w_f[None, :])  # (nv_j, 3)
        term2 = A[body][:, None] * (S[:, 3:] @ dpxw.T)
        dJtl_q = dJtl_q + term1 + term2

    return (
        tensors["dtau_dq"] + dJtl_q,
        tensors["dtau_dv"],
        jnp.concatenate(rows_q, axis=0),
        jnp.concatenate(rows_v, axis=0),
    )


@highest_precision
def constrained_fd_tensors(
    model, q, v, tau, contact_frames, active,
    prox_mu=1e-8, kp=0.0, kd=0.0, p_refs=None, contact_dims=None,
):
    """Primal constrained solve + analytic derivative matrices.

    Returns the ``_cfd_internals`` dict extended with
      ra1_q, ra1_v (nv,nv): ∂(RNEA + Jᵀλ)/∂(q,v) at fixed (a*, λ*)
      r2_q, r2_v (nc,nv):   ∂(J a + γ_tot)/∂(q,v) at fixed a* (act-masked)
    from which KKT tangents solve as
      [M Jᵀ; J −μ][da; dλ] = [dτ − ra1_θ dθ; −r2_θ dθ].
    The adaptive fp32 μ floor (``mu_eff``) is treated as locally constant
    (its derivative is below round-off significance; exact in fp64 where
    ``prox_mu`` dominates).  Reference role:
    ``computeConstraintDynamicsDerivatives``
    (``multibody-constraint-fwd.hxx:60``).

    Do not differentiate THROUGH this function — the solver consumes it
    inside custom-JVP rules where no tangents flow."""
    from . import contact as _contact

    dtype = q.dtype
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    out = _contact._cfd_internals(
        model, q, v, tau, contact_frames, active,
        prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
        contact_dims=contact_dims,
    )
    prefs = (
        jnp.asarray(p_refs, dtype)
        if p_refs is not None
        else jnp.zeros((len(contact_frames), 3), dtype)
    )
    ra1_q, ra1_v, r2_q, r2_v = _fd_rows_std(
        model, q, v, out["a"], out["lam"], active.astype(dtype),
        prefs, tuple(contact_frames), tuple(contact_dims),
        float(kp), float(kd), p_refs is not None,
    )
    out["ra1_q"] = ra1_q
    out["ra1_v"] = ra1_v
    out["r2_q"] = r2_q
    out["r2_v"] = r2_v
    return out


def constrained_fd_derivatives(
    model, q, v, tau, contact_frames, active,
    prox_mu=1e-8, kp=0.0, kd=0.0, p_refs=None, contact_dims=None,
):
    """Full analytic Jacobians of ``constrained_fwd_dynamics``: returns
    ``(a, forces, da_dq, da_dv, da_dtau, df_dq, df_dv, df_dtau)`` with
    q-derivatives in local tangent coordinates.  Test/inspection API; the
    solver path consumes the same tensors through the custom JVP."""
    out = constrained_fd_tensors(
        model, q, v, tau, contact_frames, active,
        prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
        contact_dims=contact_dims,
    )
    Jc, MinvJt = out["Jc"], out["MinvJt"]
    nv = model.nv
    nc = Jc.shape[0]
    dt = q.dtype
    eye = jnp.eye(nv, dtype=dt)

    # ONE joint KKT solve for all 3nv tangent directions (q, v, τ):
    # the three per-direction solves share the M and G factorizations and
    # one multi-RHS traversal.
    from ...gar.riccati import spd_solve

    R1 = jnp.concatenate([-out["ra1_q"], -out["ra1_v"], eye], axis=1)
    R2 = jnp.concatenate(
        [-out["r2_q"], -out["r2_v"], jnp.zeros((nc, nv), dt)], axis=1
    )
    X = spd_solve(out["M"], R1)
    dlam = spd_solve(out["G"], Jc @ X - R2)
    D = X - MinvJt @ dlam
    da_dq, da_dv, da_dt = D[:, :nv], D[:, nv : 2 * nv], D[:, 2 * nv :]
    dl_dq, dl_dv, dl_dt = (
        dlam[:, :nv], dlam[:, nv : 2 * nv], dlam[:, 2 * nv :]
    )
    return (
        out["a"], -out["lam"],
        da_dq, da_dv, da_dt,
        -dl_dq, -dl_dv, -dl_dt,
    )


# ---------------------------------------------------------------------------
# custom-JVP wiring (the solver-facing fast path)
# ---------------------------------------------------------------------------


def _is_zero(t):
    return isinstance(t, SymbolicZero)


def _any_nonzero(tree):
    return any(not _is_zero(leaf) for leaf in jax.tree_util.tree_leaves(tree))


def _materialize(tangents):
    return jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.aval.shape, t.aval.dtype) if _is_zero(t) else t,
        tangents,
        is_leaf=_is_zero,
    )


def _coords_to_local(cspace, q, dq):
    """Map a configuration-coordinate tangent (nq) to local tangent
    coordinates (nv) via the chart: d/dε difference(q, ·) at q along dq
    (exact for tangents generated by ``integrate`` — the solver's
    Jacobian convention)."""
    return jax.jvp(lambda y: cspace.difference(q, y), (q,), (dq,))[1]


def _ext_generalized(model, kin, ext):
    """Generalized torque of external spatial forces given in joint-local
    frames (the linear ``fext ↦ τ`` map of RNEA at fixed kinematics)."""
    R, p = kin["R"], kin["p"]
    fl_w = jnp.einsum("nij,nj->ni", R, ext[:, :3])
    tau_w = jnp.einsum("nij,nj->ni", R, ext[:, 3:]) + jnp.cross(p, fl_w)
    fxw = jnp.concatenate([fl_w, tau_w], axis=1)
    return jnp.sum(kin["Phi"] * (kin["A"].T @ fxw), axis=1)


@functools.lru_cache(maxsize=None)
def aba_custom(has_ext: bool):
    """custom-JVP wrapped free forward dynamics (closed over the static
    ``has_ext`` arity).  Model-parameter tangents fall back to exact
    autodiff of the raw implementation (rare: system identification)."""

    def _raw(model, q, v, tau, ext=None):
        return rbd._aba_impl(model, q, v, tau, ext)

    def _rule(primals, tangents, ext, dext):
        model, q, v, tau = primals[:4]
        dmodel, dq, dv, dtau = tangents[:4]
        pack = _aba_deriv_pack(model, q, v, tau, ext)
        tang = jnp.zeros_like(pack["a"])
        if not _is_zero(dq):
            xi = _coords_to_local(model.configuration_space(), q, dq)
            tang = tang + pack["da_dq"] @ xi
        if not _is_zero(dv):
            tang = tang + pack["da_dv"] @ dv
        if not _is_zero(dtau):
            tang = tang + pack["solve_M"](dtau)
        if dext is not None and not _is_zero(dext):
            tang = tang + pack["solve_M"](
                _ext_generalized(model, pack["kin"], dext)
            )
        return pack["a"], tang

    if has_ext:

        @jax.custom_jvp
        def fn(model, q, v, tau, ext):
            return rbd._aba_impl(model, q, v, tau, ext)

        @functools.partial(fn.defjvp, symbolic_zeros=True)
        def _jvp(primals, tangents):
            if _any_nonzero(tangents[0]):
                return jax.jvp(_raw, primals, _materialize(tangents))
            return _rule(primals, tangents, primals[4], tangents[4])

        return fn

    @jax.custom_jvp
    def fn0(model, q, v, tau):
        return rbd._aba_impl(model, q, v, tau, None)

    @functools.partial(fn0.defjvp, symbolic_zeros=True)
    def _jvp0(primals, tangents):
        if _any_nonzero(tangents[0]):
            return jax.jvp(
                lambda m, qq, vv, tt: rbd._aba_impl(m, qq, vv, tt, None),
                primals,
                _materialize(tangents),
            )
        return _rule(primals, tangents, None, None)

    return fn0


@functools.lru_cache(maxsize=None)
def cfd_custom(contact_frames, contact_dims, prox_mu, kp, kd,
               has_prefs: bool):
    """custom-JVP wrapped constrained forward dynamics, closed over the
    static contact configuration.  Tangents w.r.t. model parameters or the
    activity schedule fall back to exact autodiff."""
    from . import contact as _contact

    def _raw(model, q, v, tau, active, p_refs=None):
        out = _contact._cfd_internals(
            model, q, v, tau, contact_frames, active,
            prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
            contact_dims=contact_dims,
        )
        return out["a"], -out["lam"]

    @highest_precision
    def _tangent_rule(primals, tangents, p_refs, dprefs):
        model, q, v, tau, active = primals[:5]
        dmodel, dq, dv, dtau, dactive = tangents[:5]
        out = constrained_fd_tensors(
            model, q, v, tau, contact_frames, active,
            prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
            contact_dims=contact_dims,
        )
        dt = q.dtype
        nc = out["Jc"].shape[0]
        rhs1 = jnp.zeros((model.nv,), dt)
        rhs2 = jnp.zeros((nc,), dt)
        if not _is_zero(dtau):
            rhs1 = rhs1 + dtau
        if not _is_zero(dq):
            xi = _coords_to_local(model.configuration_space(), q, dq)
            rhs1 = rhs1 - out["ra1_q"] @ xi
            rhs2 = rhs2 - out["r2_q"] @ xi
        if not _is_zero(dv):
            rhs1 = rhs1 - out["ra1_v"] @ dv
            rhs2 = rhs2 - out["r2_v"] @ dv
        if has_prefs and dprefs is not None and not _is_zero(dprefs):
            # γ rows include +kp(p − pref)·act → ∂pref = −kp·act rows;
            # rhs2 = −∂θγ dθ
            offs = _contact.contact_offsets(contact_dims)
            for k in range(len(contact_frames)):
                rhs2 = rhs2.at[offs[k] : offs[k] + 3].add(
                    kp * active[k] * dprefs[k]
                )
        x = out["solve_M"](rhs1)
        dlam = out["solve_G"](out["Jc"] @ x - rhs2)
        da = x - out["MinvJt"] @ dlam
        return (out["a"], -out["lam"]), (da, -dlam)

    if has_prefs:

        @jax.custom_jvp
        def fn(model, q, v, tau, active, p_refs):
            return _raw(model, q, v, tau, active, p_refs)

        @functools.partial(fn.defjvp, symbolic_zeros=True)
        def _jvp(primals, tangents):
            if _any_nonzero(tangents[0]) or not _is_zero(tangents[4]):
                return jax.jvp(_raw, primals, _materialize(tangents))
            return _tangent_rule(primals, tangents, primals[5], tangents[5])

        return fn

    @jax.custom_jvp
    def fn0(model, q, v, tau, active):
        return _raw(model, q, v, tau, active)

    @functools.partial(fn0.defjvp, symbolic_zeros=True)
    def _jvp0(primals, tangents):
        if _any_nonzero(tangents[0]) or not _is_zero(tangents[4]):
            return jax.jvp(
                lambda m, qq, vv, tt, ac: _raw(m, qq, vv, tt, ac),
                primals,
                _materialize(tangents),
            )
        return _tangent_rule(primals, tangents, None, None)

    return fn0


# ---------------------------------------------------------------------------
# kinematic residual derivatives (frame velocity, CoM) — round-4 extension
# ---------------------------------------------------------------------------


def velocity_tensors(model, q, v, kin=None):
    """Light-weight subset of :func:`rnea_tensors`: the primal kinematics
    plus the body-velocity derivative tensor dV (nv, nb, 6) only — what the
    kinematic residual Jacobians need (no inertia/force pass)."""
    dt = q.dtype
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    top, dj, D_np, pb_np = _dof_tables(model)
    A = kin["A"]
    S = kin["Phi"]
    Vb = kin["V"]
    maskjb = A.T[:, :, None]
    pb_safe = np.maximum(pb_np, 0)
    has_par = jnp.asarray((pb_np >= 0).astype(np.float64), dt)[:, None]
    Vpar = Vb[pb_safe] * has_par
    dV = maskjb * motion_cross(
        S[:, None, :], Vb[None, :, :] - Vpar[:, None, :]
    )
    return {"kin": kin, "S": S, "A": A, "Vb": Vb, "dV": dV}


def frame_velocity_jacobians(model, q, v, frame_id):
    """Analytic (Jq, Jv), each (6, nv): tangent-space Jacobians of the
    LOCAL-frame spatial velocity of ``frame_id`` (the
    ``FrameVelocityResidual`` derivative)."""
    t = velocity_tensors(model, q, v)
    kin, S, A, Vb, dV = t["kin"], t["S"], t["A"], t["Vb"], t["dV"]
    body = model.frame_parents[frame_id]
    R, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    V = Vb[body]
    omega, VL = V[3:], V[:3]
    ab = A[body]  # (nv,)

    # velocity part: the LOCAL frame Jacobian rows
    J6 = rbd.frame_jacobian_lwa(model, q, frame_id, kin=kin)
    Jv = jnp.concatenate([R.T @ J6[:3], R.T @ J6[3:]], axis=0)

    # configuration part: transport of the frame pose + body velocity
    dom, dVL = dV[:, body, 3:], dV[:, body, :3]
    dp = ab[:, None] * (S[:, :3] + jnp.cross(S[:, 3:], p[None, :]))
    wmask = ab[:, None] * S[:, 3:]  # frame ang. velocity of each dof screw
    v_at_f = VL + jnp.cross(omega, p)
    # d(Rᵀx)[j] = −Rᵀ(w_j × x) + Rᵀ dx[j]
    dlin = -jnp.cross(wmask, v_at_f[None, :]) + (
        dVL + jnp.cross(dom, p[None, :]) + jnp.cross(omega[None, :], dp)
    )
    dang = -jnp.cross(wmask, omega[None, :]) + dom
    # rows j of dlin/dang are world vectors; LOCAL coords are Rᵀ·row, i.e.
    # (d @ R) has rows (Rᵀ d_j)ᵀ — transpose to (3, nv)
    Jq = jnp.concatenate([(dlin @ R).T, (dang @ R).T], axis=0)
    return Jq, Jv


def com_jacobian(model, q, kin=None):
    """Analytic (3, nv) CoM translation Jacobian (pinocchio
    ``jacobianCenterOfMass`` role)."""
    dt = q.dtype
    if kin is None:
        kin = rbd.kinematics(model, q)
    A, S = kin["A"], kin["Phi"]
    m = model.mass.astype(dt)
    c_w = kin["p"] + jnp.einsum(
        "nij,nj->ni", kin["R"], model.com.astype(dt)
    )
    # dof j moves body b's com with the point velocity of screw S_j
    dcom = jnp.einsum(
        "b,bj,jbs->js", m, A, S[:, None, :3]
        + jnp.cross(S[:, None, 3:], c_w[None, :, :]),
    ) / jnp.sum(m)
    return dcom.T  # (3, nv)


def com_velocity_jacobians(model, q, v):
    """Analytic (Jq, Jv), each (3, nv), of the CoM linear velocity."""
    t = velocity_tensors(model, q, v)
    kin, S, A, Vb, dV = t["kin"], t["S"], t["A"], t["Vb"], t["dV"]
    dt = q.dtype
    m = model.mass.astype(dt)
    M = jnp.sum(m)
    c_w = kin["p"] + jnp.einsum(
        "nij,nj->ni", kin["R"], model.com.astype(dt)
    )
    Jv = com_jacobian(model, q, kin=kin)
    # vcom = Σ m_b (VL_b + ω_b × c_b)/M; differentiate each term
    omega = Vb[:, 3:]
    dc = A.T[:, :, None] * (
        S[:, None, :3] + jnp.cross(S[:, None, 3:], c_w[None, :, :])
    )  # (nv, nb, 3)
    dterm = (
        dV[:, :, :3]
        + jnp.cross(dV[:, :, 3:], c_w[None, :, :])
        + jnp.cross(omega[None, :, :], dc)
    )  # (nv, nb, 3)
    Jq = (jnp.einsum("b,jbs->js", m, dterm) / M).T
    return Jq, Jv
