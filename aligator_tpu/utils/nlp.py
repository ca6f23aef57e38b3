"""Export a TrajOptProblem as a flat NLP (reference
``examples/convert_to_nlp.py``, which bridges aligator problems to
proxsuite-nlp).

The accelerator-native analog: flatten the trajectory decision variables into one
vector z = [dx₀, u₀, dx₁, u₁, …, dx_N] of *tangent-space* coordinates around
a base trajectory, and expose jitted objective / constraint callables with
exact JAX derivatives. The scipy bridge (:func:`solve_scipy`) turns any
generic NLP solver into an independent end-to-end oracle for the ProxDDP
solver (the reference uses ProxNLP in the same role).

Constraint-set mapping: EqualityConstraint → equality rows; NegativeOrthant
→ g(z) ≤ 0; BoxConstraint → two inequality blocks. Nonsmooth penalty sets
(L1Penalty) have no NLP-constraint equivalent and are rejected.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import TrajOptProblem, evaluate
from ..core.sets import BoxConstraint, EqualityConstraint, NegativeOrthant


def _unflatten(problem: TrajOptProblem, base_xs, base_us, z):
    """z (tangent coords around (base_xs, base_us)) → (xs, us)."""
    space = problem.space
    N = problem.nsteps
    ndx, nu = space.ndx, problem.nu
    blk = ndx + nu
    dxs = jnp.stack([z[i * blk : i * blk + ndx] for i in range(N + 1)])
    dus = jnp.stack(
        [z[i * blk + ndx : (i + 1) * blk] for i in range(N)]
    )
    xs = jax.vmap(space.integrate)(base_xs, dxs)
    return xs, base_us + dus


def _stage_cstr_rows(problem: TrajOptProblem):
    """Classify stacked stage-constraint rows into (eq, ineq_le) index sets
    plus box (lower, upper) handling. Returns row-index arrays per kind."""
    eq_rows, le_rows, box_rows = [], [], []
    off = 0
    stages = problem.stages
    for (f, s), dim in zip(stages.constraints, stages.cstr_dims):
        rows = list(range(off, off + dim))
        if isinstance(s, EqualityConstraint):
            eq_rows += rows
        elif isinstance(s, NegativeOrthant):
            le_rows += rows
        elif isinstance(s, BoxConstraint):
            box_rows += rows
        else:
            raise TypeError(
                f"constraint set {type(s).__name__} has no NLP equivalent"
            )
        off += dim
    return eq_rows, le_rows, box_rows


def to_nlp(problem: TrajOptProblem, base_xs, base_us):
    """Build jitted NLP callables over the flat tangent variable z.

    Returns a dict: ``objective/grad`` (scalar, (nz,)), ``cons_eq/jac_eq``
    (initial condition + dynamics + equality rows), ``cons_ineq/jac_ineq``
    (g(z) ≤ 0 convention), and ``nz``.
    """
    N = problem.nsteps
    ndx = problem.space.ndx
    nz = (N + 1) * ndx + N * problem.nu
    eq_rows, le_rows, box_rows = _stage_cstr_rows(problem)
    stage_sets = dict(zip(_all_rows(problem), _all_sets(problem)))

    # terminal rows, classified the same way
    t_eq, t_le, t_box = [], [], []
    off = 0
    for (f, s), dim in zip(problem.term_constraints, problem.term_cstr_dims):
        rows = list(range(off, off + dim))
        if isinstance(s, EqualityConstraint):
            t_eq += rows
        elif isinstance(s, NegativeOrthant):
            t_le += rows
        elif isinstance(s, BoxConstraint):
            t_box += rows
        else:
            raise TypeError(
                f"terminal set {type(s).__name__} has no NLP equivalent"
            )
        off += dim

    def _eval(z):
        xs, us = _unflatten(problem, base_xs, base_us, z)
        return evaluate(problem, xs, us), xs, us

    def objective(z):
        data, _, _ = _eval(z)
        return data.cost

    def cons_eq(z):
        data, _, _ = _eval(z)
        ninit = problem.space.ndx if problem.init_cstr_dim < 0 else problem.init_cstr_dim
        parts = [data.init_res[:ninit], data.dyn_res.ravel()]
        if eq_rows:
            parts.append(data.cstr_vals[:, jnp.asarray(eq_rows)].ravel())
        if t_eq:
            parts.append(data.term_cstr_vals[jnp.asarray(t_eq)])
        return jnp.concatenate(parts)

    def cons_ineq(z):
        """g(z) ≤ 0 rows."""
        data, _, _ = _eval(z)
        parts = []
        if le_rows:
            parts.append(data.cstr_vals[:, jnp.asarray(le_rows)].ravel())
        for r in box_rows:
            s = stage_sets[r]
            v = data.cstr_vals[:, r]
            parts += [v - s.upper_row(r), s.lower_row(r) - v]
        if t_le:
            parts.append(data.term_cstr_vals[jnp.asarray(t_le)])
        for r in t_box:
            raise NotImplementedError("terminal box rows: use le form")
        if not parts:
            return jnp.zeros((0,), z.dtype)
        return jnp.concatenate(parts)

    return dict(
        objective=jax.jit(objective),
        grad=jax.jit(jax.grad(objective)),
        cons_eq=jax.jit(cons_eq),
        jac_eq=jax.jit(jax.jacrev(cons_eq)),
        cons_ineq=jax.jit(cons_ineq),
        jac_ineq=jax.jit(jax.jacrev(cons_ineq)),
        nz=nz,
    )


def _all_rows(problem):
    rows = []
    off = 0
    for (f, s), dim in zip(problem.stages.constraints, problem.stages.cstr_dims):
        rows += list(range(off, off + dim))
        off += dim
    return rows


def _all_sets(problem):
    sets = []
    for (f, s), dim in zip(problem.stages.constraints, problem.stages.cstr_dims):
        sets += [_RowView(s, k) for k in range(dim)]
    return sets


class _RowView:
    """Per-row accessor into a (possibly stacked) BoxConstraint."""

    def __init__(self, s, k):
        self.s, self.k = s, k

    def upper_row(self, _):
        u = jnp.asarray(self.s.upper)
        return u[..., self.k] if u.ndim else u

    def lower_row(self, _):
        l = jnp.asarray(self.s.lower)
        return l[..., self.k] if l.ndim else l


def solve_scipy(
    problem: TrajOptProblem,
    xs_init,
    us_init,
    tol=1e-9,
    max_iter=500,
):
    """Solve the flattened NLP with scipy SLSQP — an independent oracle for
    cross-validating the ProxDDP/FDDP solvers (the role proxsuite-nlp plays
    for the reference in ``examples/convert_to_nlp.py``)."""
    from scipy.optimize import minimize

    fns = to_nlp(problem, xs_init, us_init)
    z0 = np.zeros(fns["nz"])

    cons = [
        dict(
            type="eq",
            fun=lambda z: np.asarray(fns["cons_eq"](jnp.asarray(z))),
            jac=lambda z: np.asarray(fns["jac_eq"](jnp.asarray(z))),
        )
    ]
    n_ineq = int(fns["cons_ineq"](jnp.zeros(fns["nz"])).shape[0])
    if n_ineq:
        cons.append(
            dict(
                type="ineq",  # scipy convention: fun(z) >= 0
                fun=lambda z: -np.asarray(fns["cons_ineq"](jnp.asarray(z))),
                jac=lambda z: -np.asarray(fns["jac_ineq"](jnp.asarray(z))),
            )
        )

    r = minimize(
        lambda z: float(fns["objective"](jnp.asarray(z))),
        z0,
        jac=lambda z: np.asarray(fns["grad"](jnp.asarray(z))),
        constraints=cons,
        method="SLSQP",
        options=dict(maxiter=max_iter, ftol=tol),
    )
    xs, us = _unflatten(problem, xs_init, us_init, jnp.asarray(r.x))
    return xs, us, r
