"""Contact-constrained forward dynamics.

Counterpart of ``MultibodyConstraintFwdDynamicsTpl`` (reference
``modelling/dynamics/multibody-constraint-fwd.hpp:20``), which calls
Pinocchio's constrained-dynamics solver with ``RigidConstraintModel`` and
prox settings. Here: 3D point contacts and 6D (flat-foot) contacts in the
LOCAL_WORLD_ALIGNED frame — the two contact types the reference's legged
examples use (``examples/solo_jump.py`` 3D, ``examples/talos_walk.py``
CONTACT_6D) — solved as a proximally-regularized KKT system

    [[M,  Jᶜᵀ], [Jᶜ, −μI]] [a; −λ] = [τ − b; −(γ + Baumgarte)]

via a Cholesky Schur complement (the μ-regularization mirrors Pinocchio's
``ProximalSettings`` and keeps the system solvable for redundant contacts).
Contact activity is a per-contact 0/1 flag array — rows of inactive contacts
are masked (μ-dominated), so contact *schedules* can vary per stage through
stacked stage parameters without shape changes.

Contact Jacobians are analytic (``rbd.frame_jacobian_lwa`` from the
world-frame dof axes) and all contacts share one kinematics pass.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ...gar import smallmat
from ..._precision import highest_precision
from ..._pytree import pytree_dataclass, static_field
from ..dynamics.ode import ODE
from . import model as rbd


def frame_point_and_world_velocity(model, q, v, frame_id, kin=None):
    """World position p(q) and world-frame linear velocity of a frame origin."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    R, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    par = model.frame_parents[frame_id]
    V = kin["V"][par]
    return p, V[:3] + jnp.cross(V[3:], p)


def frame_velocity_lwa(model, q, v, frame_id, kin=None):
    """6D LOCAL_WORLD_ALIGNED frame velocity (linear at frame origin, angular),
    world-aligned axes."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p = rbd.frame_placement(model, q, frame_id, kin=kin)
    par = model.frame_parents[frame_id]
    V = kin["V"][par]
    return jnp.concatenate([V[:3] + jnp.cross(V[3:], p), V[3:]])


def contact_jacobian(model, q, frame_id, kin=None):
    """LOCAL_WORLD_ALIGNED 3×nv contact Jacobian: ∂(world point velocity)/∂v."""
    return rbd.frame_jacobian_lwa(model, q, frame_id, kin=kin)[:3]


def _drift(model, q, v, frame_id, dim):
    """γ = d/dt(Jᶜ v) at zero joint acceleration (acceleration drift)."""
    cspace = model.configuration_space()

    def vel_of_dq(dq):
        qq = cspace.integrate(q, dq)
        if dim == 3:
            _, vel = frame_point_and_world_velocity(model, qq, v, frame_id)
            return vel
        return frame_velocity_lwa(model, qq, v, frame_id)

    z = jnp.zeros((model.nv,), q.dtype)
    return jax.jvp(vel_of_dq, (z,), (v,))[1]


# ---------------------------------------------------------------------------
# body-body (loop-closure) constraints — the grasp/RigidConstraintModel
# case between two JOINTS rather than joint-vs-world (reference: Pinocchio
# RigidConstraintModel with joint2_id != 0, as built by
# /root/reference/examples/ur10_ballistic.py:131-165 create_rcm)
# ---------------------------------------------------------------------------


def relative_velocity_lwa(model, q, v, f1, f2, dim, kin=None):
    """Relative LOCAL_WORLD_ALIGNED velocity of frame ``f1`` w.r.t. ``f2``,
    linear part evaluated at f1's origin (the constraint anchor point):
    (v₁(p₁) − v₂(p₁)[, ω₁ − ω₂])."""
    if kin is None:
        kin = rbd.kinematics(model, q, v)
    _, p1 = rbd.frame_placement(model, q, f1, kin=kin)
    V1 = kin["V"][model.frame_parents[f1]]
    V2 = kin["V"][model.frame_parents[f2]]
    lin = (V1[:3] + jnp.cross(V1[3:], p1)) - (V2[:3] + jnp.cross(V2[3:], p1))
    if dim == 3:
        return lin
    return jnp.concatenate([lin, V1[3:] - V2[3:]])


def relative_jacobian_lwa(model, q, f1, f2, dim, kin=None):
    """(dim × nv) Jacobian of :func:`relative_velocity_lwa` w.r.t. v —
    the loop-closure constraint Jacobian J = J₁(p₁) − J₂(p₁)."""
    if kin is None:
        kin = rbd.kinematics(model, q)
    _, p1 = rbd.frame_placement(model, q, f1, kin=kin)
    Phi, A = kin["Phi"], kin["A"]

    def body_jac_at(par):
        mask = A[par][:, None]
        lin = (Phi[:, :3] + jnp.cross(Phi[:, 3:], p1[None, :])) * mask
        ang = Phi[:, 3:] * mask
        return jnp.concatenate([lin.T, ang.T], axis=0)  # (6, nv)

    J = body_jac_at(model.frame_parents[f1]) - body_jac_at(
        model.frame_parents[f2]
    )
    return J[:dim]


def _rel_drift(model, q, v, f1, f2, dim):
    """Acceleration drift of the loop constraint: d/dt(J_rel v) at zero
    joint acceleration."""
    cspace = model.configuration_space()

    def vel_of_dq(dq):
        qq = cspace.integrate(q, dq)
        return relative_velocity_lwa(model, qq, v, f1, f2, dim)

    z = jnp.zeros((model.nv,), q.dtype)
    return jax.jvp(vel_of_dq, (z,), (v,))[1]


def contact_drift(model, q, v, frame_id):
    return _drift(model, q, v, frame_id, 3)


@highest_precision
def _cfd_internals(
    model,
    q,
    v,
    tau,
    contact_frames,
    active,
    prox_mu=1e-8,
    kp=0.0,
    kd=0.0,
    p_refs=None,
    contact_dims=None,
    contact_frames2=None,
    diff_solves=False,
):
    """Primal constrained-dynamics solve returning the internals needed by
    the analytic derivative pass (``derivatives.py``): the factorized mass
    matrix and Delassus solvers, the masked contact Jacobian, and the
    kinematics pass.

    ``diff_solves``: route the SPD solves through the implicit-diff
    dispatch (``lax.custom_linear_solve``) — REQUIRED when callers
    differentiate straight through this function (the loop-constraint
    autodiff path): tangents then come from exact solves of the tangent
    system instead of autodiff through the Cholesky recursion, which is
    measurably better conditioned (the ur10_ballistic OCP converges with
    implicit tangents and stalls without them).  The analytic custom-JVP
    path (world contacts) keeps the plain closure — cheaper, and its rules
    never differentiate through here.

    ``contact_frames2``: optional per-contact second frame (int, or None
    for a world contact).  An entry with a second frame is a body-body
    LOOP constraint — relative velocity of frame1 w.r.t. frame2 pinned to
    zero (the grasp / Pinocchio ``RigidConstraintModel`` joint2 ≠ world
    case, reference ``examples/ur10_ballistic.py:131-165``)."""
    dtype = q.dtype
    nv = model.nv
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    if contact_frames2 is None:
        contact_frames2 = (None,) * len(contact_frames)

    M = rbd.mass_matrix(model, q)
    b = rbd.rnea(model, q, v, jnp.zeros((nv,), dtype))
    free = tau - b

    kin = rbd.kinematics(model, q, v)
    Js, gammas, act_rows = [], [], []
    for k, fid in enumerate(contact_frames):
        dim = contact_dims[k]
        f2 = contact_frames2[k]
        if f2 is not None:
            # loop constraint: relative velocity of fid w.r.t. f2
            J = relative_jacobian_lwa(model, q, fid, f2, dim, kin=kin)
            g = _rel_drift(model, q, v, fid, f2, dim)
            vrel = relative_velocity_lwa(model, q, v, fid, f2, dim, kin=kin)
            corr = kd * vrel
            if p_refs is not None:
                _, p1 = rbd.frame_placement(model, q, fid, kin=kin)
                _, p2 = rbd.frame_placement(model, q, f2, kin=kin)
                perr = p1 - p2 - p_refs[k]
                if dim == 3:
                    corr = corr + kp * perr
                else:
                    corr = corr + kp * jnp.concatenate(
                        [perr, jnp.zeros(3, dtype)]
                    )
            Js.append(J)
            gammas.append(g + corr)
            act_rows.append(jnp.full((dim,), active[k], dtype))
            continue
        J6 = rbd.frame_jacobian_lwa(model, q, fid, kin=kin)
        J = J6[:dim]
        g = _drift(model, q, v, fid, dim)
        # Baumgarte stabilization on velocity (and position via p_refs)
        if dim == 3:
            p, vw = frame_point_and_world_velocity(model, q, v, fid, kin=kin)
            corr = kd * vw
            if p_refs is not None:
                corr = corr + kp * (p - p_refs[k])
        else:
            v6 = frame_velocity_lwa(model, q, v, fid, kin=kin)
            corr = kd * v6
            if p_refs is not None:
                _, p = rbd.frame_placement(model, q, fid, kin=kin)
                corr = corr + kp * jnp.concatenate(
                    [p - p_refs[k], jnp.zeros(3, dtype)]
                )
        Js.append(J)
        gammas.append(g + corr)
        act_rows.append(jnp.full((dim,), active[k], dtype))
    Jc = jnp.concatenate(Js, axis=0)  # (Σdims, nv)
    gamma = jnp.concatenate(gammas, axis=0)

    act = jnp.concatenate(act_rows)
    Jc = Jc * act[:, None]
    gamma = gamma * act

    # merged multi-RHS mass solve [Jc', free] — one factorization and one
    # triangular traversal
    solve_M = smallmat.spd_solver(M)
    if diff_solves:
        from ...gar.riccati import spd_solve

        Y = spd_solve(
            M, jnp.concatenate([Jc.T, free[:, None]], axis=1)
        )
    else:
        Y = solve_M(jnp.concatenate([Jc.T, free[:, None]], axis=1))
    MinvJt = Y[:, :-1]  # (nv, Σdims)
    a_free = Y[:, -1]

    # Delassus operator with prox regularization; inactive rows reduce to
    # μ·λ = 0 → λ = 0. The Delassus matrix is structurally rank-deficient
    # for redundant contact sets (e.g. 4 coplanar point feet on a 14-dof
    # quadruped), so the regularization must be ≥ round-off at the working
    # dtype: floor μ at 64·eps·max(diag G), else the fp32 Cholesky NaNs
    # (the reference runs this KKT in fp64 where 1e-8 is enough,
    # ``multibody/constraint-fwd-dynamics.hxx``).
    G0 = Jc @ MinvJt
    G0 = 0.5 * (G0 + G0.T)
    eps = jnp.finfo(dtype).eps
    mu_eff = jnp.maximum(
        jnp.asarray(prox_mu, dtype),
        64.0 * eps * jnp.max(jnp.diagonal(G0)),
    )
    G = G0 + mu_eff * jnp.eye(Jc.shape[0], dtype=dtype)
    rhs = Jc @ a_free + gamma
    solve_G = smallmat.spd_solver(G)
    if diff_solves:
        from ...gar.riccati import spd_solve

        lam = spd_solve(G, rhs)
    else:
        lam = solve_G(rhs)

    a = a_free - MinvJt @ lam
    return {
        "a": a,
        "lam": lam,
        "kin": kin,
        "Jc": Jc,
        "act": act,
        "solve_M": solve_M,
        "solve_G": solve_G,
        "MinvJt": MinvJt,
        "mu_eff": mu_eff,
        "M": M,
        "G": G,
    }


def constrained_fwd_dynamics(
    model,
    q,
    v,
    tau,
    contact_frames,
    active,
    prox_mu=1e-8,
    kp=0.0,
    kd=0.0,
    p_refs=None,
    contact_dims=None,
    contact_frames2=None,
):
    """Forward dynamics under active 3D/6D contacts.

    ``contact_dims``: static tuple of 3 or 6 per contact (default all-3).
    ``contact_frames2``: optional per-contact second frame — body-body
    loop constraints (grasps); see :func:`_cfd_internals`.
    Returns ``(a, forces)`` with forces the flat (Σdims,) contact-force
    vector in world-aligned coordinates (zero entries for inactive
    contacts); slice per contact with ``contact_offsets``.

    Derivatives are analytic by default (``derivatives.py`` custom-JVP:
    world-frame einsum RNEA derivatives + KKT-factorization reuse,
    replacing the reference's ``computeConstraintDynamicsDerivatives``
    role, ``multibody-constraint-fwd.hxx:60``); autodiff falls back
    automatically when model parameters / activity flags carry tangents,
    when ``prox_mu``/``kp``/``kd`` are traced values, or for loop
    constraints (exact JAX autodiff through the KKT solve).
    """
    if contact_dims is not None:
        contact_dims = tuple(contact_dims)
    has_loop = contact_frames2 is not None and any(
        f2 is not None for f2 in contact_frames2
    )
    static_ok = all(
        isinstance(val, (int, float)) for val in (prox_mu, kp, kd)
    ) and not has_loop
    if static_ok:
        from .derivatives import cfd_custom

        fn = cfd_custom(
            tuple(contact_frames),
            contact_dims if contact_dims is not None
            else (3,) * len(contact_frames),
            float(prox_mu),
            float(kp),
            float(kd),
            p_refs is not None,
        )
        if p_refs is None:
            return fn(model, q, v, tau, active)
        return fn(model, q, v, tau, active, p_refs)
    out = _cfd_internals(
        model, q, v, tau, contact_frames, active,
        prox_mu=prox_mu, kp=kp, kd=kd, p_refs=p_refs,
        contact_dims=contact_dims, contact_frames2=contact_frames2,
        diff_solves=has_loop,
    )
    return out["a"], -out["lam"]


def contact_offsets(contact_dims):
    """Static start offsets of each contact's force block in the flat vector."""
    return tuple(int(o) for o in np.cumsum((0,) + tuple(contact_dims))[:-1])


def underactuated_constrained_rnea(
    model, q, v, act_matrix, contact_frames, contact_dims=None,
    contact_frames2=None,
):
    """Static inverse dynamics under contacts for an underactuated robot.

    Least-squares solve of ``[B, Jcᵀ]·[u; f] = nle(q, v)`` — the torque and
    world-aligned contact forces that hold the robot at (q, v) with zero
    acceleration. Used to warm-start whole-body OCPs (reference
    ``underactuatedConstrainedInverseDynamics``,
    ``modelling/multibody/constrained-rnea.hpp:22-61``; called by
    ``examples/talos_walk.py``).

    Returns ``(u, forces)`` with ``forces`` the flat (Σdims,) vector, the
    same convention as :func:`constrained_fwd_dynamics`.
    """
    dtype = q.dtype
    if contact_dims is None:
        contact_dims = (3,) * len(contact_frames)
    if contact_frames2 is None:
        contact_frames2 = (None,) * len(contact_frames)
    nu = act_matrix.shape[1]

    nle = rbd.rnea(model, q, v, jnp.zeros((model.nv,), dtype))

    kin = rbd.kinematics(model, q, v)
    Js = [
        relative_jacobian_lwa(model, q, fid, f2, dim, kin=kin)
        if f2 is not None
        else rbd.frame_jacobian_lwa(model, q, fid, kin=kin)[:dim]
        for fid, f2, dim in zip(contact_frames, contact_frames2, contact_dims)
    ]
    Jc = jnp.concatenate(Js, axis=0)  # (Σdims, nv)

    # B u + Jc' f = nle: f is the force the environment applies ON the
    # robot — the same sign convention as constrained_fwd_dynamics
    # (M a + nle = tau + Jc' f; a standing robot gets fz = +m g)
    work = jnp.concatenate([act_matrix, Jc.T], axis=1)  # (nv, nu+Σdims)
    sol = jnp.linalg.lstsq(work, nle)[0]
    return sol[:nu], sol[nu:]


@pytree_dataclass
class MultibodyConstraintFwdDynamics(ODE):
    """Phase-space ODE with contact-constrained accelerations.

    ``active`` is a data leaf: stack it over stages to encode a contact
    schedule (e.g. flight phases in a jump, support switches in a walk).
    ``contact_dims`` selects 3D point or 6D flat-foot contacts per frame.
    """

    model: rbd.RobotModel
    actuation: jax.Array  # (nv, nu)
    active: jax.Array  # (n_contacts,)
    contact_frames: tuple = static_field(default=())
    contact_dims: tuple = static_field(default=None)
    prox_mu: float = static_field(default=1e-8)
    kd: float = static_field(default=1e-2)
    # position-level Baumgarte gain + per-contact position references
    # ((n_contacts, 3) data leaf, or None): world targets for world
    # contacts, RELATIVE (p1 - p2) targets for loop constraints — the
    # reference RigidConstraintModel corrector Kp role
    # (ur10_ballistic.py:167-170 sets Kp=1e-3, Kd=2*sqrt(Kp))
    kp: float = static_field(default=0.0)
    p_refs: jax.Array = None
    # per-contact second frame for body-body loop constraints (grasps);
    # None = all world contacts
    contact_frames2: tuple = static_field(default=None)

    def xdot(self, space, x, u):
        nq = self.model.nq
        q, v = x[..., :nq], x[..., nq:]
        tau = self.actuation @ u
        a, _ = constrained_fwd_dynamics(
            self.model,
            q,
            v,
            tau,
            self.contact_frames,
            self.active,
            prox_mu=self.prox_mu,
            kp=self.kp,
            kd=self.kd,
            p_refs=self.p_refs,
            contact_dims=self.contact_dims,
            contact_frames2=self.contact_frames2,
        )
        return jnp.concatenate([v, a], axis=-1)

    def acc_derivatives(self, space, x, u):
        """Analytic (a, ∂a/∂dq, ∂a/∂dv, ∂a/∂u) via the constrained-KKT
        derivative pass — the direct-assembly protocol consumed by
        ``IntegratorSemiImplEuler.jacobians``.  Loop (body-body) contacts
        use exact autodiff tangents through the KKT solve instead (the
        analytic point-derivative rows assume a world-fixed anchor)."""
        nq = self.model.nq
        q, v = x[..., :nq], x[..., nq:]
        tau = self.actuation @ u
        has_loop = self.contact_frames2 is not None and any(
            f2 is not None for f2 in self.contact_frames2
        )
        if has_loop:
            cspace = self.model.configuration_space()
            dt = jnp.result_type(x)

            def acc_of(dq, dv, du):
                out = _cfd_internals(
                    self.model, cspace.integrate(q, dq), v + dv,
                    self.actuation @ (u + du), self.contact_frames,
                    self.active, prox_mu=self.prox_mu, kp=self.kp,
                    kd=self.kd, p_refs=self.p_refs,
                    contact_dims=self.contact_dims,
                    contact_frames2=self.contact_frames2,
                    diff_solves=True,
                )
                return out["a"]

            zq = jnp.zeros((self.model.nv,), dt)
            zu = jnp.zeros_like(u)
            a = acc_of(zq, zq, zu)
            da_dq, da_dv, da_du = jax.jacfwd(acc_of, argnums=(0, 1, 2))(
                zq, zq, zu
            )
            return a, da_dq, da_dv, da_du

        from .derivatives import constrained_fd_derivatives

        (a, _f, da_dq, da_dv, da_dt, *_rest) = constrained_fd_derivatives(
            self.model, q, v, tau, self.contact_frames, self.active,
            prox_mu=self.prox_mu, kp=self.kp, kd=self.kd,
            p_refs=self.p_refs, contact_dims=self.contact_dims,
        )
        return a, da_dq, da_dv, da_dt @ self.actuation


def _contact_force(self, x, u):
    nq = self.model.nq
    q, v = x[..., :nq], x[..., nq:]
    tau = self.actuation @ u
    dims = self.contact_dims or (3,) * len(self.contact_frames)
    _, forces = constrained_fwd_dynamics(
        self.model, q, v, tau, self.contact_frames, self.active,
        prox_mu=self.prox_mu, contact_dims=dims,
    )
    off = contact_offsets(dims)[self.contact_id]
    return forces[off : off + dims[self.contact_id]]


@pytree_dataclass
class ContactForceResidual:
    """r(x, u) = f_k(x, u) − f_ref for contact k (reference
    ``modelling/multibody/contact-force.hpp:20``). The force is recovered
    from the constrained-dynamics KKT solve."""

    model: rbd.RobotModel
    actuation: jax.Array
    active: jax.Array
    f_ref: jax.Array  # (dim,)
    contact_frames: tuple = static_field(default=())
    contact_dims: tuple = static_field(default=None)
    contact_id: int = static_field(default=0)
    prox_mu: float = static_field(default=1e-8)

    def value(self, space, x, u):
        return _contact_force(self, x, u) - self.f_ref

    def jacobians(self, space, x, u):
        from ...core.functions import StageFunction

        return StageFunction.jacobians(self, space, x, u)


@pytree_dataclass
class MultibodyFrictionConeResidual:
    """Linearized friction cone on a contact force (reference
    ``modelling/multibody/multibody-friction-cone.hpp:19``):
    r ≤ 0 ⇔ force inside the pyramid."""

    model: rbd.RobotModel
    actuation: jax.Array
    active: jax.Array
    mu_friction: jax.Array
    contact_frames: tuple = static_field(default=())
    contact_dims: tuple = static_field(default=None)
    contact_id: int = static_field(default=0)
    prox_mu: float = static_field(default=1e-8)

    def value(self, space, x, u):
        f = _contact_force(self, x, u)
        fx, fy, fz = f[0], f[1], f[2]
        m = self.mu_friction
        return jnp.stack(
            [-fz, fx - m * fz, -fx - m * fz, fy - m * fz, -fy - m * fz]
        )

    def jacobians(self, space, x, u):
        from ...core.functions import StageFunction

        return StageFunction.jacobians(self, space, x, u)


@pytree_dataclass
class MultibodyWrenchConeResidual:
    """CoP/wrench-cone residual on a 6D contact (reference
    ``modelling/multibody/multibody-wrench-cone.hpp:20``): linearized
    friction pyramid on the force + center-of-pressure box from the torque,
    for a rectangular foot of half-extents (hL, hW). r ≤ 0 inside the cone.

    Rows (LOCAL_WORLD_ALIGNED wrench (f, τ) at the sole frame):
      0: −fz ≤ 0
      1-4: |fx|, |fy| ≤ μ fz
      5-8: |τx| ≤ hW fz, |τy| ≤ hL fz
    """

    model: rbd.RobotModel
    actuation: jax.Array
    active: jax.Array
    mu_friction: jax.Array
    half_length: jax.Array
    half_width: jax.Array
    contact_frames: tuple = static_field(default=())
    contact_dims: tuple = static_field(default=None)
    contact_id: int = static_field(default=0)
    prox_mu: float = static_field(default=1e-8)

    def value(self, space, x, u):
        w = _contact_force(self, x, u)  # (6,) for a 6D contact
        fx, fy, fz = w[0], w[1], w[2]
        tx, ty = w[3], w[4]
        m, hl, hw = self.mu_friction, self.half_length, self.half_width
        return jnp.stack(
            [
                -fz,
                fx - m * fz,
                -fx - m * fz,
                fy - m * fz,
                -fy - m * fz,
                tx - hw * fz,
                -tx - hw * fz,
                ty - hl * fz,
                -ty - hl * fz,
            ]
        )

    def jacobians(self, space, x, u):
        from ...core.functions import StageFunction

        return StageFunction.jacobians(self, space, x, u)
