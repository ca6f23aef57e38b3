"""Inverse LQR: recover cost weights from demonstrations by gradient
descent THROUGH the solver.

A accelerator-native capability with no reference counterpart (README "beyond the
reference"): ``gar.diff.solve`` exposes implicit-function-theorem gradients
of the LQ solution w.r.t. every problem matrix, so inverse optimal control
becomes plain ``jax.grad`` + optax. An "expert" trajectory is generated
from hidden diagonal weights (Q*, R*); the learner starts from identity
weights and matches the expert by minimizing ‖xs − xs*‖² + ‖us − us*‖²
over log-parameterized diagonals — batched over demonstrations with vmap.
"""

import jax
import jax.numpy as jnp

from aligator_tpu import gar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import diff as gar_diff

MU = 1e-8


def make_problem_template(N=40, dtype=jnp.float64):
    """Double-integrator chain, x ∈ R⁴ (two masses), u ∈ R²."""
    nx, nu = 4, 2
    dt_ = 0.1
    A = jnp.eye(nx, dtype=dtype)
    A = A.at[0, 2].set(dt_).at[1, 3].set(dt_)
    B = jnp.zeros((nx, nu), dtype).at[2, 0].set(dt_).at[3, 1].set(dt_)
    Tk = N + 1
    knots = gar.LQRKnots(
        Q=jnp.tile(jnp.eye(nx, dtype=dtype), (Tk, 1, 1)),
        S=jnp.zeros((Tk, nx, nu), dtype),
        R=jnp.tile(jnp.eye(nu, dtype=dtype), (Tk, 1, 1)),
        q=jnp.zeros((Tk, nx), dtype),
        r=jnp.zeros((Tk, nu), dtype),
        A=jnp.tile(A, (Tk, 1, 1)),
        B=jnp.tile(B, (Tk, 1, 1)),
        E=jnp.tile(-jnp.eye(nx, dtype=dtype), (Tk, 1, 1)),
        f=jnp.zeros((Tk, nx), dtype),
        C=jnp.zeros((Tk, 0, nx), dtype),
        D=jnp.zeros((Tk, 0, nu), dtype),
        d=jnp.zeros((Tk, 0), dtype),
    )
    return gar.LQRProblem(
        knots=knots,
        G0=-jnp.eye(nx, dtype=dtype),
        g0=jnp.zeros((nx,), dtype),
    )


def set_weights(problem, log_wq, log_wr, x0):
    """Apply diagonal weights and the initial condition to the template."""
    kn = problem.knots
    Tk = kn.Q.shape[0]
    Q = jnp.tile(jnp.diag(jnp.exp(log_wq)), (Tk, 1, 1))
    R = jnp.tile(jnp.diag(jnp.exp(log_wr)), (Tk, 1, 1))
    return replace(
        problem, knots=replace(kn, Q=Q, R=R), g0=x0
    )


def solve_traj(problem, log_wq, log_wr, x0):
    p = set_weights(problem, log_wq, log_wr, x0)
    xs, us, _, _ = gar_diff.solve(p, MU, MU, True)
    return xs, us


def main():
    import optax

    template = make_problem_template()
    key = jax.random.PRNGKey(0)
    x0s = jax.random.normal(key, (16, 4))  # 16 demonstrations

    # hidden expert weights
    log_wq_true = jnp.log(jnp.asarray([3.0, 0.5, 0.1, 2.0]))
    log_wr_true = jnp.log(jnp.asarray([0.3, 1.5]))
    xs_e, us_e = jax.vmap(
        lambda x0: solve_traj(template, log_wq_true, log_wr_true, x0)
    )(x0s)

    def loss(params):
        xs, us = jax.vmap(
            lambda x0: solve_traj(template, params["q"], params["r"], x0)
        )(x0s)
        return jnp.mean((xs - xs_e) ** 2) + jnp.mean((us - us_e) ** 2)

    params = {"q": jnp.zeros(4), "r": jnp.zeros(2)}
    opt = optax.adam(0.1)
    state = opt.init(params)
    lg = jax.jit(jax.value_and_grad(loss))
    for k in range(300):
        val, g = lg(params)
        updates, state = opt.update(g, state)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        if k % 50 == 0:
            print(f"iter {k:4d}  loss {float(val):.3e}")

    final = float(loss(params))
    print("loss final:", final)
    # NOTE: inverse optimal control is ill-posed — different weightings can
    # induce near-identical optimal trajectories, so exact weight recovery
    # is NOT expected; the demonstration-match loss is the success metric.
    import numpy as np

    ratio_q = np.exp(np.asarray(params["q"])) / np.exp(np.asarray(log_wq_true))
    ratio_r = np.exp(np.asarray(params["r"])) / np.exp(np.asarray(log_wr_true))
    scale = float(np.concatenate([ratio_q, ratio_r]).mean())
    print("recovered/true weight ratios (q):", np.round(ratio_q / scale, 4))
    print("recovered/true weight ratios (r):", np.round(ratio_r / scale, 4))
    return params, final


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    main()
