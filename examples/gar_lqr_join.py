"""Join two successive LQ problems by maximizing over the common costate.

Counterpart of the reference ``examples/gar-lqr-join.py``: split a horizon
at t0, θ-parameterize the first half's tail knot by the interface costate
(Gx = Aᵀ, Gu = Bᵀ, Gth = −μ·I, γ = f — the ``setupKnot`` convention of the
parallel solver, ``gar/parallel-solver.hpp:43-51``) and the second half's
head knot by the incoming dynamics (Gx = Eᵀ), then solve

    θ* = argmax_θ  V₁(θ) + V₂(θ)   ⇔   (H₁ + H₂) θ* = −(g₁ + g₂)

with the value-function sensitivities ``th_grad``/``th_hess`` each backward
sweep exposes. The fused trajectories must match the joint solve — this is
the 2-leg special case of the parallel-in-time solver, demonstrated through
the public θ-API.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import gar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import riccati
from aligator_tpu.gar.lqr_problem import LQRProblem, add_parameterization


def split_and_join(problem: LQRProblem, t0: int, mu: float = 1e-7):
    """Split ``problem`` (explicit dynamics) at knot ``t0``, solve the two
    θ-parameterized halves, and fuse via the optimal interface costate.

    Returns ``(xs, us, vs, lams, theta)`` of the fused solution (same
    shapes/indexing as ``gar.solve`` on the joint problem; the interface
    costate is ``lams[t0] = θ``)."""
    kn = problem.knots
    T = kn.Q.shape[0]
    nx = kn.nx
    dt = kn.Q.dtype
    eye = jnp.eye(nx, dtype=dt)

    def sl(a, lo, hi):
        return jax.tree.map(lambda x: x[lo:hi], a)

    # first half: knots [0, t0), tail knot parameterized by the costate
    kn1 = add_parameterization(sl(kn, 0, t0), nx)
    kn1 = replace(
        kn1,
        Gx=kn1.Gx.at[-1].set(kn1.A[-1].T),
        Gu=kn1.Gu.at[-1].set(kn1.B[-1].T),
        Gth=kn1.Gth.at[-1].set(-mu * eye),
        gamma=kn1.gamma.at[-1].set(kn1.f[-1]),
    )
    prob1 = LQRProblem(knots=kn1, G0=problem.G0, g0=problem.g0)

    # second half: knots [t0, T), head knot carries the incoming dynamics
    kn2 = add_parameterization(sl(kn, t0, T), nx)
    kn2 = replace(kn2, Gx=kn2.Gx.at[0].set(kn2.E[0].T if kn2.E is not None else -eye))
    # zero G0 = relaxed 0·x = 0 initial "constraint" (multiplier ≡ 0); keeps
    # the stacked multiplier array uniform (nc0 = nx padding convention)
    prob2 = LQRProblem(
        knots=kn2,
        G0=jnp.zeros((nx, nx), dt),
        g0=jnp.zeros((nx,), dt),
    )

    f1 = riccati.backward(prob1, mu, mu, assume_explicit=False)
    f2 = riccati.backward(prob2, mu, mu, assume_explicit=False)

    H = f1.th_hess + f2.th_hess
    g = f1.th_grad + f2.th_grad
    theta = -jnp.linalg.solve(H, g)

    xs1, us1, vs1, lams1 = riccati.forward(f1, theta=theta)
    xs2, us2, vs2, lams2 = riccati.forward(f2, theta=theta)

    xs = jnp.concatenate([xs1, xs2], axis=0)
    us = jnp.concatenate([us1, us2], axis=0)
    vs = jnp.concatenate([vs1, vs2], axis=0)
    # the interface costate IS θ (prob2's "initial multiplier" slot is
    # empty: nc0 = 0) — splice it in where the joint solve has λ_{t0}
    lams = jnp.concatenate([lams1, theta[None], lams2[1:]], axis=0)
    return xs, us, vs, lams, theta


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    T, nx, nu = 10, 2, 1
    problem = gar.random_problem(
        jax.random.PRNGKey(42), T - 1, nx, nu, 0, dtype=jnp.float64
    )
    mu = 1e-8

    xs_j, us_j, vs_j, lams_j = gar.solve(problem, mu, mu, assume_explicit=True)
    xs, us, vs, lams, theta = split_and_join(problem, t0=T // 2, mu=mu)

    print("theta (interface costate):", np.asarray(theta))
    print("lambda_t0 of joint solve: ", np.asarray(lams_j[T // 2]))
    print("max |dx|:", float(jnp.max(jnp.abs(xs - xs_j))))
    print("max |du|:", float(jnp.max(jnp.abs(us - us_j))))
    print("max |dlam|:", float(jnp.max(jnp.abs(lams - lams_j))))
