"""Analytic RBD derivative validation against the autodiff oracle.

Round-4 VERDICT item 1: the analytic world-frame einsum derivatives
(``modelling/multibody/derivatives.py`` — the
``computeRNEADerivatives`` / ``computeABADerivatives`` /
``computeConstraintDynamicsDerivatives`` roles, reference
``multibody-free-fwd.hxx:66`` / ``multibody-constraint-fwd.hxx:60``)
must match ``jacfwd`` through the raw implementations in fp64, on
fixed-base, free-flyer, 3D- and 6D-contact models, and through both the
custom-JVP forward path and reverse mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aligator_tpu.modelling.multibody import contact as ct
from aligator_tpu.modelling.multibody import derivatives as drv
from aligator_tpu.modelling.multibody import model as rbd
from aligator_tpu.modelling.multibody.humanoid import make_humanoid
from aligator_tpu.modelling.multibody.quadruped import make_quadruped
from aligator_tpu.modelling.multibody.robots import make_ur5


def _rand_state(model, seed=0):
    key = jax.random.PRNGKey(seed)
    cspace = model.configuration_space()
    q = cspace.rand(key)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
    v = jax.random.normal(k1, (model.nv,))
    tau = jax.random.normal(k2, (model.nv,))
    return cspace, q, v, tau


@pytest.mark.parametrize("use_fext", [False, True])
def test_rnea_derivatives_ur5(use_fext):
    model = make_ur5()
    cspace, q, v, a = _rand_state(model)
    fext = (
        0.3 * jax.random.normal(jax.random.PRNGKey(9), (model.njoints, 6))
        if use_fext
        else None
    )
    dtau_dq, dtau_dv = drv.rnea_derivatives(model, q, v, a, fext=fext)
    z = jnp.zeros((model.nv,))
    dq_ad = jax.jacfwd(
        lambda d: rbd.rnea(model, cspace.integrate(q, d), v, a, fext)
    )(z)
    dv_ad = jax.jacfwd(lambda d: rbd.rnea(model, q, v + d, a, fext))(z)
    s = max(1.0, float(jnp.abs(dq_ad).max()))
    assert float(jnp.abs(dtau_dq - dq_ad).max()) < 1e-9 * s
    assert float(jnp.abs(dtau_dv - dv_ad).max()) < 1e-9 * s


def test_rnea_and_aba_derivatives_freeflyer():
    model = make_humanoid()
    cspace, q, v, tau = _rand_state(model, seed=1)
    a = jax.random.normal(jax.random.PRNGKey(4), (model.nv,))
    dtau_dq, dtau_dv = drv.rnea_derivatives(model, q, v, a)
    z = jnp.zeros((model.nv,))
    dq_ad = jax.jacfwd(
        lambda d: rbd.rnea(model, cspace.integrate(q, d), v, a)
    )(z)
    dv_ad = jax.jacfwd(lambda d: rbd.rnea(model, q, v + d, a))(z)
    s = max(1.0, float(jnp.abs(dq_ad).max()))
    assert float(jnp.abs(dtau_dq - dq_ad).max()) < 1e-9 * s
    assert float(jnp.abs(dtau_dv - dv_ad).max()) < 1e-9 * s

    # aba: analytic vs autodiff of the raw implementation, and the public
    # custom-JVP path must agree with both
    a0, da_dq, da_dv, solve_M = drv.aba_derivatives(model, q, v, tau)
    da_dq_ad = jax.jacfwd(
        lambda d: rbd._aba_impl(model, cspace.integrate(q, d), v, tau)
    )(z)
    da_dq_pub = jax.jacfwd(
        lambda d: rbd.aba(model, cspace.integrate(q, d), v, tau)
    )(z)
    s = max(1.0, float(jnp.abs(da_dq_ad).max()))
    assert float(jnp.abs(da_dq - da_dq_ad).max()) < 1e-8 * s
    assert float(jnp.abs(da_dq_pub - da_dq_ad).max()) < 1e-8 * s
    assert float(jnp.abs(a0 - rbd._aba_impl(model, q, v, tau)).max()) == 0.0


@pytest.mark.parametrize(
    "robot,dims,kp,kd,prefs",
    [
        pytest.param("humanoid", (6, 6), 0.0, 1e-2, False,
                     marks=pytest.mark.slow),
        pytest.param("humanoid", (6, 6), 10.0, 0.5, True,
                     marks=pytest.mark.slow),
        ("quadruped", (3, 3, 3, 3), 0.0, 1e-2, False),
    ],
)
def test_constrained_fd_derivatives(robot, dims, kp, kd, prefs):
    if robot == "humanoid":
        model = make_humanoid()
        frames = (model.frame_id("left_sole"), model.frame_id("right_sole"))
    else:
        model = make_quadruped()
        frames = tuple(model.frame_id(f"foot{i}") for i in range(4))
    cspace, q, v, tau = _rand_state(model, seed=2)
    # one inactive contact exercises the act-masked rows
    active = jnp.ones((len(frames),)).at[0].set(0.0)
    p_refs = (
        0.1 * jax.random.normal(jax.random.PRNGKey(3), (len(frames), 3))
        if prefs
        else None
    )
    kw = dict(kp=kp, kd=kd, p_refs=p_refs, contact_dims=dims)

    def raw(qq, vv, tt):
        out = ct._cfd_internals(model, qq, vv, tt, frames, active, **kw)
        return out["a"], -out["lam"]

    (a, f, da_dq, da_dv, da_dt, df_dq, df_dv, df_dt) = (
        drv.constrained_fd_derivatives(model, q, v, tau, frames, active, **kw)
    )
    z = jnp.zeros((model.nv,))
    Ja, Jf = jax.jacfwd(lambda d: raw(cspace.integrate(q, d), v, tau))(z)
    s = max(1.0, float(jnp.abs(Ja).max()), float(jnp.abs(Jf).max()))
    assert float(jnp.abs(da_dq - Ja).max()) < 1e-8 * s
    assert float(jnp.abs(df_dq - Jf).max()) < 1e-8 * s
    Ja, Jf = jax.jacfwd(lambda d: raw(q, v + d, tau))(z)
    assert float(jnp.abs(da_dv - Ja).max()) < 1e-8 * s
    assert float(jnp.abs(df_dv - Jf).max()) < 1e-8 * s
    Ja, Jf = jax.jacfwd(lambda d: raw(q, v, tau + d))(z)
    assert float(jnp.abs(da_dt - Ja).max()) < 1e-8 * s
    assert float(jnp.abs(df_dt - Jf).max()) < 1e-8 * s

    # the public function's custom-JVP must reproduce the analytic matrices
    # in forward AND reverse mode
    def pub(d):
        return ct.constrained_fwd_dynamics(
            model, cspace.integrate(q, d), v, tau, frames, active, **kw
        )

    Ja_pub, _ = jax.jacfwd(pub)(z)
    assert float(jnp.abs(Ja_pub - da_dq).max()) < 1e-8 * s
    g_pub = jax.grad(lambda d: pub(d)[0].sum())(z)
    g_raw = jax.grad(
        lambda d: raw(cspace.integrate(q, d), v, tau)[0].sum()
    )(z)
    assert float(jnp.abs(g_pub - g_raw).max()) < 1e-8 * s


def test_model_param_tangent_fallback():
    """Differentiating w.r.t. model parameters (mass) must fall back to
    exact autodiff rather than silently dropping the tangent."""
    model = make_ur5()
    cspace, q, v, tau = _rand_state(model, seed=5)

    def a_of_mass_pub(dm):
        from aligator_tpu._pytree import replace

        m2 = replace(model, mass=model.mass + dm)
        return rbd.aba(m2, q, v, tau)

    def a_of_mass_raw(dm):
        from aligator_tpu._pytree import replace

        m2 = replace(model, mass=model.mass + dm)
        return rbd._aba_impl(m2, q, v, tau)

    z = jnp.zeros_like(model.mass)
    Jp = jax.jacfwd(a_of_mass_pub)(z)
    Jr = jax.jacfwd(a_of_mass_raw)(z)
    s = max(1.0, float(jnp.abs(Jr).max()))
    assert float(jnp.abs(Jp - Jr).max()) < 1e-10 * s


@pytest.mark.parametrize("which", ["free", "flexible", "contact"])
def test_semi_implicit_euler_direct_jacobians(which):
    """IntegratorSemiImplEuler.jacobians assembles (A, B, E) directly from
    the analytic acceleration derivatives + manifold chart Jacobians; must
    match the generic autodiff path to machine precision (round-4
    derivative-phase lever)."""
    from aligator_tpu.core.dynamics import ExplicitDynamics
    from aligator_tpu.modelling import IntegratorSemiImplEuler
    from aligator_tpu.modelling.dynamics.multibody_free import (
        MultibodyFlexibleFwdDynamics,
        MultibodyFreeFwdDynamics,
    )
    from aligator_tpu.modelling.multibody.contact import (
        MultibodyConstraintFwdDynamics,
    )

    if which == "contact":
        model = make_humanoid()
        act = jnp.eye(model.nv, model.nv - 6, -6)
        ode = MultibodyConstraintFwdDynamics(
            model=model, actuation=act, active=jnp.array([1.0, 0.0]),
            contact_frames=(
                model.frame_id("left_sole"), model.frame_id("right_sole")
            ),
            contact_dims=(6, 6),
        )
        nu = model.nv - 6
    else:
        model = make_ur5()
        nu = model.nv
        if which == "free":
            ode = MultibodyFreeFwdDynamics(
                model=model, actuation=jnp.eye(nu)
            )
        else:
            ode = MultibodyFlexibleFwdDynamics(
                model=model, actuation=jnp.eye(nu),
                stiffness=jnp.full(nu, 2.0), damping=jnp.full(nu, 0.5),
                q_rest=jnp.zeros(nu),
            )

    space = model.phase_space()
    key = jax.random.PRNGKey(0)
    q = model.configuration_space().rand(key)
    v = 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (model.nv,))
    x = jnp.concatenate([q, v])
    u = jax.random.normal(jax.random.fold_in(key, 2), (nu,))
    dyn = IntegratorSemiImplEuler(ode=ode, timestep=jnp.asarray(0.015))
    y = space.integrate(
        dyn.forward(space, x, u),
        0.01 * jax.random.normal(jax.random.fold_in(key, 3), (space.ndx,)),
    )
    direct = dyn.jacobians(space, x, u, y)
    auto = ExplicitDynamics.jacobians(dyn, space, x, u, y)
    for z1, z0 in zip(direct, auto):
        s = max(1.0, float(jnp.abs(z0).max()))
        assert float(jnp.abs(z1 - z0).max()) < 1e-9 * s


def test_residual_analytic_jacobians():
    """The multibody residual classes override jacobians with analytic
    forms (frame translation/placement/velocity, CoM translation/velocity,
    gravity compensation) — all must match the StageFunction autodiff
    default to machine precision on the floating-base humanoid."""
    from aligator_tpu.core.functions import StageFunction
    from aligator_tpu.modelling.multibody.residuals import (
        CenterOfMassTranslationResidual,
        CenterOfMassVelocityResidual,
        FramePlacementResidual,
        FrameTranslationResidual,
        FrameVelocityResidual,
        GravityCompensationResidual,
    )

    model = make_humanoid()
    space = model.phase_space()
    key = jax.random.PRNGKey(0)
    q = model.configuration_space().rand(key)
    v = 0.4 * jax.random.normal(jax.random.fold_in(key, 1), (model.nv,))
    x = jnp.concatenate([q, v])
    u = jax.random.normal(jax.random.fold_in(key, 2), (model.nv,))
    fid = model.frame_id("left_sole")
    residuals = [
        FrameTranslationResidual(model=model,
                                 p_ref=jnp.array([0.1, 0.2, 0.3]),
                                 frame_id=fid),
        FramePlacementResidual(model=model, R_ref=jnp.eye(3),
                               p_ref=jnp.array([0.1, 0.2, 0.3]),
                               frame_id=fid),
        FrameVelocityResidual(model=model, v_ref=jnp.zeros(6),
                              frame_id=fid),
        CenterOfMassTranslationResidual(model=model,
                                        p_ref=jnp.zeros(3)),
        CenterOfMassVelocityResidual(model=model, v_ref=jnp.zeros(3)),
        GravityCompensationResidual(model=model,
                                    actuation=jnp.eye(model.nv)),
    ]
    for res in residuals:
        Jx1, Ju1 = res.jacobians(space, x, u)
        Jx0, Ju0 = StageFunction.jacobians(res, space, x, u)
        s = max(1.0, float(jnp.abs(Jx0).max()))
        name = type(res).__name__
        assert float(jnp.abs(Jx1 - Jx0).max()) < 1e-9 * s, name
        assert float(jnp.abs(Ju1 - Ju0).max()) < 1e-12, name


def _quadruped_batch(batch):
    model = make_quadruped()
    frames = tuple(model.frame_id(f"foot{i}") for i in range(4))
    from aligator_tpu.modelling.multibody.quadruped import (
        standing_configuration,
    )

    cspace = model.configuration_space()
    q0 = standing_configuration(model)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    dq = 0.05 * jax.random.normal(k1, (batch, model.nv))
    qs = jax.vmap(lambda d: cspace.integrate(q0, d))(dq)
    vs = 0.2 * jax.random.normal(k2, (batch, model.nv))
    taus = 2.0 * jax.random.normal(k3, (batch, model.nv))
    return model, frames, cspace, qs, vs, taus


def test_fd_rows_std_batched_matches_per_instance():
    """The derivative-rows pass under vmap (how the batched solver runs it)
    equals per-instance calls."""
    batch = 2
    model, frames, _, qs, vs, taus = _quadruped_batch(batch)
    active = jnp.ones((4,))
    prefs = jnp.zeros((4, 3))

    def rows(q, v, tau):
        out = ct._cfd_internals(model, q, v, tau, frames, active, kd=1e-2,
                                contact_dims=(3, 3, 3, 3))
        return drv._fd_rows_std(
            model, q, v, out["a"], out["lam"], active, prefs, frames,
            (3, 3, 3, 3), 0.0, 1e-2, False,
        )

    batched = jax.jit(jax.vmap(rows))(qs, vs, taus)
    rows_1 = jax.jit(rows)
    for b in range(batch):
        single = rows_1(qs[b], vs[b], taus[b])
        for rb, r1 in zip(batched, single):
            s = max(1.0, float(jnp.abs(r1).max()))
            assert float(jnp.abs(rb[b] - r1).max()) < 1e-8 * s


def test_fd_rows_std_batched_vs_jacfwd():
    """Batched contact-dynamics derivatives, built from the derivative-rows
    pass, against float64 ``jacfwd`` of the raw forward dynamics."""
    batch = 2
    model, frames, cspace, qs, vs, taus = _quadruped_batch(batch)
    active = jnp.ones((4,))
    kw = dict(kd=1e-2, contact_dims=(3, 3, 3, 3))

    def raw(q, v, tau):
        out = ct._cfd_internals(model, q, v, tau, frames, active, **kw)
        return out["a"], -out["lam"]

    def jac(q, v, tau):
        z = jnp.zeros((model.nv,))
        Jq = jax.jacfwd(lambda d: raw(cspace.integrate(q, d), v, tau))(z)
        Jv = jax.jacfwd(lambda d: raw(q, v + d, tau))(z)
        Jt = jax.jacfwd(lambda d: raw(q, v, tau + d))(z)
        return Jq[0], Jv[0], Jt[0], Jq[1], Jv[1], Jt[1]

    got = jax.jit(jax.vmap(
        lambda q, v, t: drv.constrained_fd_derivatives(
            model, q, v, t, frames, active, **kw
        )[2:]
    ))(qs, vs, taus)
    ref = jax.jit(jax.vmap(jac))(qs, vs, taus)
    for g, r in zip(got, ref):
        s = max(1.0, float(jnp.abs(r).max()))
        assert float(jnp.abs(g - r).max()) < 1e-8 * s
