"""Solver-level parametric (θ) sensitivities of the optimal value.

Reference role: ``RiccatiSolverBase::thGrad/thHess``
(``/root/reference/include/aligator/gar/riccati-base.hpp:26-34``) surfaces
value-function parameter sensitivities from the LQ layer to the MPC layer.
gar computes and tests the θ recursion (``gar/riccati.py`` ``Vxt/Vtt/vt``,
``tests/gar/test_riccati.py::test_theta_gradient_hessian``); this module is
the solver-level exposure: given a CONVERGED ProxDDP solve of a problem
family ``θ ↦ problem(θ)``, attach the parametric blocks of the final LQ
subproblem and harvest ``th_grad = dV/dθ`` and ``th_hess = d²V/dθ²`` into
:class:`ProxDDPResults`.

Accelerator-native design: the problem family is a pure pytree-returning function
(θ may enter cost targets/weights, constraint offsets, dynamics parameters,
or the initial state); the θ cross-blocks are computed by ``jax.jacfwd``
of the stacked Lagrangian gradients — nth forward tangents through the
(vmapped) derivative stack — rather than hand-written per-cost θ hooks.
The whole path is jit/vmap-compatible, so batched MPC can harvest
per-scenario sensitivities in one dispatch.

Semantics (checked against central finite differences in
``tests/test_sensitivity.py``):

* ``th_grad`` — gradient of the optimal value V(θ).  At a converged
  primal-dual point this is the envelope gradient ∂ℒ/∂θ (the LQ forward
  correction vanishes as dual_infeas → 0).
* ``th_hess`` — Gauss-Newton Hessian of V(θ): the Schur complement of the
  proximal LQ KKT system onto θ, i.e. the re-optimized second-order
  sensitivity (what an SQP/MPC layer needs for warm-start extrapolation
  x*(θ+δ) ≈ x*(θ) − K·(∂²ℒ/∂x∂θ)δ).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .._pytree import replace
from ..core import problem as problem_mod
from ..core.manifolds import VectorSpace
from ..gar import riccati
from . import proxddp as P


def _lagrangian_pieces(prob, cfg, xs, us, vs, vs_term, lams):
    """Stacked Lagrangian gradients (Lxs, Lus) and the per-stage scalar
    Lagrangian contributions s (N+1,) at a fixed primal-dual point."""
    data = problem_mod.compute_derivatives(prob, xs, us)
    Lxs, Lus = P._lagrangian_grads(prob, cfg, data, lams, vs, vs_term)
    s_stage = (
        data.stage_costs
        + jnp.einsum("ti,ti->t", lams[1:], data.dyn_res)
        + (jnp.einsum("ti,ti->t", vs, data.cstr_vals) if vs.size else 0.0)
    )
    s_term = data.term_cost + lams[0] @ data.init_res
    if vs_term.size:
        s_term = s_term + vs_term @ data.term_cstr_vals
    s = jnp.concatenate([s_stage, s_term[None]], axis=0)
    return Lxs, Lus, s


def _lagrangian_values(prob, cfg, xs, us, vs, vs_term, lams):
    """Per-stage scalar Lagrangian only (cheap second-derivative path for
    Gth — values, no problem derivatives)."""
    data = problem_mod.evaluate(prob, xs, us)
    s_stage = (
        data.stage_costs
        + jnp.einsum("ti,ti->t", lams[1:], data.dyn_res)
        + (jnp.einsum("ti,ti->t", vs, data.cstr_vals) if vs.size else 0.0)
    )
    s_term = data.term_cost + lams[0] @ data.init_res
    if vs_term.size:
        s_term = s_term + vs_term @ data.term_cstr_vals
    return jnp.concatenate([s_stage, s_term[None]], axis=0)


def theta_sensitivities(
    problem_of_theta: Callable,
    theta: jax.Array,
    cfg: P.ProxDDPConfig,
    res: P.ProxDDPResults,
) -> P.ProxDDPResults:
    """Attach ``th_grad``/``th_hess`` to a converged solve of
    ``problem_of_theta(theta)``.

    ``problem_of_theta`` must be a pure function θ → :class:`TrajOptProblem`
    (same structure for all θ).  ``res`` is the converged result of
    ``solvers.solve(problem_of_theta(theta), cfg)``.  Returns ``res`` with
    ``th_grad`` (nth,) and ``th_hess`` (nth, nth) filled.

    Cost: nth forward tangents through one derivative pass (the θ
    cross-blocks) + nth² evaluation passes (Gth) + one θ-aware Riccati
    backward sweep.
    """
    prob0 = problem_of_theta(theta)
    xs, us, vs, vs_term, lams = res.xs, res.us, res.vs, res.vs_term, res.lams
    mu = res.mu_final
    if mu is None:
        mu = jnp.asarray(
            max(cfg.mu_lower_bound, 1e-8), xs.dtype
        )
    nth = theta.shape[-1]
    N = prob0.nsteps
    nu = prob0.nu
    dt = xs.dtype

    # θ cross-blocks: Gx[t] = ∂²ℒ/∂x_t∂θ, Gu[t] = ∂²ℒ/∂u_t∂θ,
    # gamma[t] = ∂ℒ_t/∂θ — one jacfwd over the nth directions
    def pieces(th):
        return _lagrangian_pieces(
            problem_of_theta(th), cfg, xs, us, vs, vs_term, lams
        )

    Gx, Gu_s, gamma = jax.jacfwd(pieces)(theta)
    # Gth[t] = ∂²ℒ_t/∂θ² — second derivative of the scalar pieces only
    Gth = jax.jacfwd(
        jax.jacfwd(
            lambda th: _lagrangian_values(
                problem_of_theta(th), cfg, xs, us, vs, vs_term, lams
            )
        )
    )(theta)
    Gu = jnp.concatenate([Gu_s, jnp.zeros((1, nu, nth), dt)], axis=0)

    # final LQ subproblem at the converged iterate (reference
    # updateLQSubproblem at the accepted point, solver-proxddp.hxx:802)
    data = problem_mod.compute_derivatives(prob0, xs, us)
    import types

    st_like = types.SimpleNamespace(
        mu=mu, prev_lams=lams, prev_vs=vs, prev_vs_term=vs_term
    )
    m = P._compute_multipliers(
        prob0, cfg, data, st_like, lams, vs, vs_term
    )
    Lxs, Lus = P._lagrangian_grads(prob0, cfg, data, lams, vs, vs_term)
    preg = jnp.asarray(max(cfg.reg_init, cfg.reg_min), dt)
    lq = P._assemble_lq(prob0, cfg, data, m, Lxs, Lus, preg, mu)
    lq = replace(
        lq, knots=replace(lq.knots, Gx=Gx, Gu=Gu, Gth=Gth, gamma=gamma)
    )

    assume_explicit = isinstance(prob0.space, VectorSpace) and getattr(
        prob0.stages.dynamics, "is_explicit", True
    )
    facs = riccati.backward(
        lq, cfg.dyn_al_scale * mu, mu, assume_explicit
    )
    return replace(res, th_grad=facs.th_grad, th_hess=facs.th_hess)


def solve_with_sensitivities(
    problem_of_theta: Callable,
    theta: jax.Array,
    cfg: P.ProxDDPConfig = P.ProxDDPConfig(),
    **solve_kwargs,
) -> P.ProxDDPResults:
    """Solve ``problem_of_theta(theta)`` and attach θ sensitivities."""
    res = P.solve(problem_of_theta(theta), cfg, **solve_kwargs)
    return theta_sensitivities(problem_of_theta, theta, cfg, res)
