"""Cyclic (periodic) LQ problem via the θ-parameterization.

Counterpart of the reference ``examples/gar-cycle-lqr-1d.py`` /
``gar-cycle-lqr-2d.py``: enforce periodicity x₀ = x_T by treating its
multiplier as the parameter θ — ``Gx[0] = +I`` and ``Gx[T] = −I`` put
``θᵀ(x₀ − x_T)`` into the Lagrangian, the backward sweep exposes the dual
function's gradient/Hessian (``th_grad``/``th_hess``), and

    θ* = −H⁻¹ g

recovers the periodic orbit. Mid-horizon state targets make the orbit
non-trivial (the reference pulls the state to +0.2 then −0.1).
"""

import jax
import jax.numpy as jnp

from aligator_tpu._pytree import replace
from aligator_tpu.gar import riccati
from aligator_tpu.gar.lqr_problem import (
    LQRKnots,
    LQRProblem,
    add_parameterization,
)


def create_cyclic_problem(T=30, nx=1, nu=1, dtype=jnp.float64, seed=42):
    """Stable-ish scalar chain with drift f, mid-horizon targets, terminal
    target x_f, and NO initial condition (the orbit is free)."""
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    Tk = T + 1

    Q = jnp.tile(0.01 * jnp.eye(nx, dtype=dtype), (Tk, 1, 1))
    R = jnp.tile(0.01 * jnp.eye(nu, dtype=dtype), (Tk, 1, 1))
    S = jnp.zeros((Tk, nx, nu), dtype)
    q = jnp.zeros((Tk, nx), dtype)
    r = jnp.zeros((Tk, nu), dtype)
    r = r.at[:T].set(0.01 * (2.0 * jax.random.uniform(k1, (T, nu), dtype) - 1.0))
    A = jnp.tile(1.2 * jnp.eye(nx, dtype=dtype), (Tk, 1, 1))
    B = jnp.tile(jnp.eye(nx, nu, dtype=dtype), (Tk, 1, 1))
    E = jnp.tile(-jnp.eye(nx, dtype=dtype), (Tk, 1, 1))
    f = jnp.zeros((Tk, nx), dtype)
    f = f.at[:T].set(0.1 * (2.0 * jax.random.uniform(k2, (T, nx), dtype) - 1.0))

    # terminal target x_f = 0.05; mid-horizon pulls to +0.2 and −0.1
    xf = 0.05 * jnp.ones((nx,), dtype)
    Q = Q.at[T].set(jnp.eye(nx, dtype=dtype))
    q = q.at[T].set(-xf)
    for t0, v in ((T // 3, 0.2), (2 * T // 3, -0.1)):
        Q = Q.at[t0].set(0.05 * jnp.eye(nx, dtype=dtype))
        q = q.at[t0].set(-0.05 * v * jnp.ones((nx,), dtype))

    nc = 0
    knots = LQRKnots(
        Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, E=E, f=f,
        C=jnp.zeros((Tk, nc, nx), dtype),
        D=jnp.zeros((Tk, nc, nu), dtype),
        d=jnp.zeros((Tk, nc), dtype),
    )
    # free initial state: zero G0 (relaxed 0·x = 0, multiplier ≡ 0)
    return LQRProblem(
        knots=knots,
        G0=jnp.zeros((nx, nx), dtype),
        g0=jnp.zeros((nx,), dtype),
    )


def solve_cyclic(problem: LQRProblem, mu=1e-9):
    """Solve with the periodicity constraint x₀ = x_T via θ."""
    kn = problem.knots
    nx = kn.nx
    eye = jnp.eye(nx, dtype=kn.Q.dtype)
    if kn.nth != nx:
        kn = add_parameterization(kn, nx)
    kn = replace(
        kn,
        Gx=kn.Gx.at[0].set(eye).at[-1].set(-eye),
    )
    prob = replace(problem, knots=kn)
    factors = riccati.backward(prob, mu, mu, assume_explicit=False)
    theta = -jnp.linalg.solve(factors.th_hess, factors.th_grad)
    xs, us, vs, lams = riccati.forward(factors, theta=theta)
    return xs, us, lams, theta


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    problem = create_cyclic_problem(T=30)
    xs, us, lams, theta = solve_cyclic(problem)
    print("x0:", np.asarray(xs[0]), " xT:", np.asarray(xs[-1]))
    print("periodicity gap |x0 - xT|:", float(jnp.max(jnp.abs(xs[0] - xs[-1]))))
    print("theta (periodicity multiplier):", np.asarray(theta))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.arange(xs.shape[0])
        plt.plot(t, np.asarray(xs)[:, 0], marker=".")
        plt.hlines(float(xs[0, 0]), 0, t[-1], colors="k", linestyles="--")
        plt.title("Cyclic LQ problem")
        plt.xlabel("$t$")
        plt.ylabel("$x$")
        plt.savefig("/tmp/gar_cyclic_lqr.png", dpi=120)
        print("plot: /tmp/gar_cyclic_lqr.png")
    except ImportError:
        pass
