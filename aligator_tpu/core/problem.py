"""Stage models and trajectory-optimization problems.

Counterpart of ``StageModelTpl`` / ``TrajOptProblemTpl`` (reference
``include/aligator/core/stage-model.hpp:24``,
``core/traj-opt-problem.hpp:78``) — re-designed for XLA:

* a :class:`StageModel` is a pytree of pure-function components (cost,
  dynamics, constraint (function, set) pairs); the manifold and dims are
  static metadata.
* a :class:`TrajOptProblem` stores ONE stage model whose array leaves carry a
  leading time axis of size N (see :func:`replicate_stage` /
  :func:`stack_stages`). Evaluation and differentiation `vmap` over that axis
  — the accelerator replacement for the reference's OpenMP-parallel stage loops
  (``core/traj-opt-problem.hxx:69,105``).
* heterogeneity across stages is expressed through stage-varying array
  parameters (weights, targets, contact flags), not through type
  heterogeneity; all stages share one structure (pad constraints if needed).

Data produced by evaluation/differentiation is a flat :class:`ProblemData`
pytree of stacked arrays — exactly the arrays the ProxDDP solver needs to
assemble its LQ subproblem.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field
from .costs import Cost
from .dynamics import ExplicitDynamics
from .manifolds import Manifold
from .sets import ConstraintSetProduct


@pytree_dataclass
class StageModel:
    """One OCP node: cost + dynamics + constraint stack."""

    cost: Cost
    dynamics: ExplicitDynamics
    constraints: tuple = ()  # ((StageFunction, ConstraintSet), ...)
    space: Manifold = static_field(default=None)
    nu: int = static_field(default=0)
    cstr_dims: tuple = static_field(default=())

    @property
    def nc(self) -> int:
        return sum(self.cstr_dims)

    def constraint_values(self, x, u):
        if not self.constraints:
            return jnp.zeros((0,), jnp.result_type(x))
        vals = [f.value(self.space, x, u) for f, _ in self.constraints]
        return jnp.concatenate(vals, -1)

    def constraint_jacobians(self, x, u):
        dt = jnp.result_type(x)
        if not self.constraints:
            return (
                jnp.zeros((0, self.space.ndx), dt),
                jnp.zeros((0, self.nu), dt),
            )
        Jxs, Jus = [], []
        for f, _ in self.constraints:
            Jx, Ju = f.jacobians(self.space, x, u)
            Jxs.append(Jx)
            Jus.append(Ju)
        return jnp.concatenate(Jxs, 0), jnp.concatenate(Jus, 0)

    def constraint_set(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(
            sets=tuple(s for _, s in self.constraints), dims=self.cstr_dims
        )


def make_stage(
    cost: Cost,
    dynamics: ExplicitDynamics,
    space: Manifold,
    nu: int,
    constraints=(),
) -> StageModel:
    """Build a StageModel, inferring constraint dims by abstract evaluation."""
    dims = []
    for f, _ in constraints:
        shape = jax.eval_shape(
            lambda f=f: f.value(space, space.neutral(), jnp.zeros((nu,)))
        )
        dims.append(shape.shape[-1])
    return StageModel(
        cost=cost,
        dynamics=dynamics,
        constraints=tuple(constraints),
        space=space,
        nu=nu,
        cstr_dims=tuple(dims),
    )


def replicate_stage(stage: StageModel, N: int) -> StageModel:
    """Broadcast every array leaf to a leading time axis of size N."""
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (N,) + jnp.shape(a)), stage)


def stack_stages(stages: list) -> StageModel:
    """Stack a list of same-structure stage models along a new leading axis."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *stages)


@pytree_dataclass
class TrajOptProblem:
    """Trajectory optimization problem over horizon N.

    The default initial condition is the constraint ``xs[0] ⊖ x0 = 0`` (the
    reference's default ``StateErrorResidual`` initial constraint,
    ``core/traj-opt-problem.hpp:78``). A general initial-condition residual
    ``g(x0) = 0`` (e.g. a :class:`FunctionSlice` of a state error, pinning
    only part of the state — reference
    ``examples/partial_initial_condition.py``) can be supplied via
    ``init_constraint``; its value/Jacobian are padded with zero rows to a
    fixed ``(ndx,)`` shape, which the μ-regularized initial KKT solve
    (``gar/riccati.py`` ``_initial_solve``) treats as exactly-inactive rows
    (zero multiplier), keeping all solver shapes static under jit.
    """

    stages: StageModel  # array leaves have leading dim N
    term_cost: Cost
    x0: jax.Array
    term_constraints: tuple = ()  # ((UnaryFunction, ConstraintSet), ...)
    init_constraint: Optional[object] = None  # StageFunction residual g(x0)
    nsteps: int = static_field(default=0)
    term_cstr_dims: tuple = static_field(default=())
    init_cstr_dim: int = static_field(default=-1)  # -1 → full-state default

    @property
    def space(self) -> Manifold:
        return self.stages.space

    @property
    def nu(self) -> int:
        return self.stages.nu

    @property
    def nc(self) -> int:
        return sum(self.stages.cstr_dims)

    @property
    def nc_term(self) -> int:
        return sum(self.term_cstr_dims)

    def stage_at(self, t: int) -> StageModel:
        return jax.tree.map(lambda a: a[t], self.stages)

    def term_constraint_values(self, x):
        if not self.term_constraints:
            return jnp.zeros((0,), jnp.result_type(x))
        u0 = jnp.zeros((self.nu,), jnp.result_type(x))
        return jnp.concatenate(
            [f.value(self.space, x, u0) for f, _ in self.term_constraints], -1
        )

    def term_constraint_jacobians(self, x):
        dt = jnp.result_type(x)
        if not self.term_constraints:
            return jnp.zeros((0, self.space.ndx), dt)
        u0 = jnp.zeros((self.nu,), dt)
        return jnp.concatenate(
            [f.jacobians(self.space, x, u0)[0] for f, _ in self.term_constraints], 0
        )

    def term_constraint_set(self) -> ConstraintSetProduct:
        return ConstraintSetProduct(
            sets=tuple(s for _, s in self.term_constraints),
            dims=self.term_cstr_dims,
        )

    def init_condition_residual(self, x):
        """Initial-condition residual, zero-padded to shape ``(ndx,)``."""
        if self.init_constraint is None:
            return self.space.difference(self.x0, x)
        u0 = jnp.zeros((self.nu,), jnp.result_type(x))
        r = self.init_constraint.value(self.space, x, u0)
        pad = self.space.ndx - r.shape[-1]
        return jnp.concatenate([r, jnp.zeros((pad,), r.dtype)], -1)

    def init_condition_jacobian(self, x):
        """∂(init residual)/∂x, zero-padded to ``(ndx, ndx)``."""
        if self.init_constraint is None:
            return self.space.jdifference(self.x0, x, 1)
        u0 = jnp.zeros((self.nu,), jnp.result_type(x))
        J = self.init_constraint.jacobians(self.space, x, u0)[0]
        pad = self.space.ndx - J.shape[-2]
        return jnp.concatenate(
            [J, jnp.zeros((pad, J.shape[-1]), J.dtype)], -2
        )


def make_problem(
    x0,
    stage: StageModel,
    nsteps: int,
    term_cost: Cost,
    term_constraints=(),
    stages: Optional[StageModel] = None,
    init_constraint=None,
) -> TrajOptProblem:
    """Build a TrajOptProblem from a single stage model (replicated) or an
    already-stacked ``stages`` pytree.

    ``init_constraint`` optionally replaces the full-state initial condition
    with a general residual ``g(x0) = 0`` of dimension ≤ ndx (reference:
    ``TrajOptProblemTpl``'s init-condition StageFunction,
    ``core/traj-opt-problem.hpp:78``)."""
    if stages is None:
        stages = replicate_stage(stage, nsteps)
    space, nu = stage.space, stage.nu
    tdims = []
    for f, _ in term_constraints:
        shape = jax.eval_shape(
            lambda f=f: f.value(space, space.neutral(), jnp.zeros((nu,)))
        )
        tdims.append(shape.shape[-1])
    init_dim = -1
    if init_constraint is not None:
        shape = jax.eval_shape(
            lambda: init_constraint.value(
                space, space.neutral(), jnp.zeros((nu,))
            )
        )
        init_dim = shape.shape[-1]
        if init_dim > space.ndx:
            raise ValueError(
                f"init_constraint dim {init_dim} exceeds ndx={space.ndx}"
            )
    return TrajOptProblem(
        stages=stages,
        term_cost=term_cost,
        x0=jnp.asarray(x0),
        term_constraints=tuple(term_constraints),
        init_constraint=init_constraint,
        nsteps=nsteps,
        term_cstr_dims=tuple(tdims),
        init_cstr_dim=init_dim,
    )


# ---------------------------------------------------------------------------
# Problem data: values and derivatives
# ---------------------------------------------------------------------------


@pytree_dataclass
class ProblemData:
    """Stacked evaluation (and optionally derivative) data of a problem.

    Mirrors ``TrajOptDataTpl`` (reference ``core/traj-opt-data.hpp``) but as
    flat arrays. Derivative fields are None when only values were computed.
    """

    cost: jax.Array  # scalar: total trajectory cost
    stage_costs: jax.Array  # (N,)
    term_cost: jax.Array  # scalar
    init_res: jax.Array  # (ndx,)    xs[0] ⊖ x0
    dyn_res: jax.Array  # (N, ndx)  value of dynamics residual
    cstr_vals: jax.Array  # (N, nc)
    term_cstr_vals: jax.Array  # (nc_term,)
    # --- derivatives (None unless compute_derivatives) ---
    Lx: Optional[jax.Array] = None  # (N+1, ndx)  cost gradients (incl terminal)
    Lu: Optional[jax.Array] = None  # (N, nu)
    Lxx: Optional[jax.Array] = None  # (N+1, ndx, ndx)
    Lxu: Optional[jax.Array] = None  # (N, ndx, nu)
    Luu: Optional[jax.Array] = None  # (N, nu, nu)
    A: Optional[jax.Array] = None  # (N, ndx, ndx)  dynamics residual ∂x
    B: Optional[jax.Array] = None  # (N, ndx, nu)
    E: Optional[jax.Array] = None  # (N, ndx, ndx)  dynamics residual ∂y
    cstr_Jx: Optional[jax.Array] = None  # (N, nc, ndx)
    cstr_Ju: Optional[jax.Array] = None  # (N, nc, nu)
    term_cstr_Jx: Optional[jax.Array] = None  # (nc_term, ndx)
    init_Jx: Optional[jax.Array] = None  # (ndx, ndx)
    # --- exact-Hessian mode: costate-contracted dynamics vector-Hessian
    # products λ_{t+1}ᵀ ∇²(dyn residual) (reference HessianApprox::EXACT,
    # core/enums.hpp:14; added to the LQ knot in solver-proxddp.hxx:839-843;
    # per-function VHP interface at core/function-abstract.hpp:73) ---
    Hxx: Optional[jax.Array] = None  # (N, ndx, ndx)
    Hxu: Optional[jax.Array] = None  # (N, ndx, nu)
    Huu: Optional[jax.Array] = None  # (N, nu, nu)


def evaluate(problem: TrajOptProblem, xs, us) -> ProblemData:
    """Evaluate costs, dynamics residuals and constraints along (xs, us).

    The stage loop is a `vmap` (reference: OpenMP parallel-for,
    ``traj-opt-problem.hxx:69``)."""
    space = problem.space
    N = problem.nsteps

    def stage_eval(stage: StageModel, x, u, y):
        c = stage.cost.value(space, x, u)
        dres = stage.dynamics.residual(space, x, u, y)
        cv = stage.constraint_values(x, u)
        return c, dres, cv

    costs, dyn_res, cstr_vals = jax.vmap(stage_eval)(
        problem.stages, xs[:N], us, xs[1:]
    )
    u0 = jnp.zeros((problem.nu,), xs.dtype)
    tc = problem.term_cost.value(space, xs[N], u0)
    tv = problem.term_constraint_values(xs[N])
    init_res = problem.init_condition_residual(xs[0])
    return ProblemData(
        cost=jnp.sum(costs) + tc,
        stage_costs=costs,
        term_cost=tc,
        init_res=init_res,
        dyn_res=dyn_res,
        cstr_vals=cstr_vals,
        term_cstr_vals=tv,
    )


def dynamics_vhp(problem: TrajOptProblem, xs, us, lams_next):
    """Costate-contracted second-order terms of the dynamics residuals.

    Returns ``(Hxx, Hxu, Huu)``, the (tangent-space) Hessian blocks of
    ``λ_{t+1}ᵀ r_t(x, u, x_{t+1})`` wrt (x, u) per stage — the reference's
    ``DynamicsModel::computeVectorHessianProducts`` (``core/dynamics.hpp:66``)
    consumed by ``HessianApprox::EXACT`` (``solver-proxddp.hxx:839-843``).
    Exact autodiff replaces the reference's hand-written VHPs.
    """
    space = problem.space
    N = problem.nsteps
    ndx = space.ndx

    def stage_vhp(stage: StageModel, x, u, y, lam):
        nu_ = u.shape[-1]

        def g(z):
            dx, du = z[:ndx], z[ndx:]
            r = stage.dynamics.residual(
                space, space.integrate(x, dx), u + du, y
            )
            return lam @ r

        H = jax.hessian(g)(jnp.zeros((ndx + nu_,), jnp.result_type(x)))
        return H[:ndx, :ndx], H[:ndx, ndx:], H[ndx:, ndx:]

    return jax.vmap(stage_vhp)(problem.stages, xs[:N], us, xs[1:], lams_next)


def compute_derivatives(
    problem: TrajOptProblem, xs, us, lams: Optional[jax.Array] = None
) -> ProblemData:
    """Evaluate + first/second-order derivatives (Gauss-Newton Hessians).

    With ``lams`` (the (N+1, ndx) costate estimates), also fills the
    dynamics vector-Hessian products for exact-Hessian mode.

    vmap over stages (reference: ``traj-opt-problem.hxx:105`` OpenMP loop)."""
    space = problem.space
    N = problem.nsteps
    dt = xs.dtype

    def stage_diff(stage: StageModel, x, u, y):
        c = stage.cost.value(space, x, u)
        Lx, Lu = stage.cost.gradients(space, x, u)
        Lxx, Lxu, Luu = stage.cost.hessians(space, x, u)
        dres = stage.dynamics.residual(space, x, u, y)
        A, B, E = stage.dynamics.jacobians(space, x, u, y)
        cv = stage.constraint_values(x, u)
        cJx, cJu = stage.constraint_jacobians(x, u)
        return c, Lx, Lu, Lxx, Lxu, Luu, dres, A, B, E, cv, cJx, cJu

    (
        costs, Lx_s, Lu, Lxx_s, Lxu, Luu, dyn_res, A, B, E, cstr_vals, cJx, cJu
    ) = jax.vmap(stage_diff)(problem.stages, xs[:N], us, xs[1:])

    u0 = jnp.zeros((problem.nu,), dt)
    tc = problem.term_cost.value(space, xs[N], u0)
    tLx, _ = problem.term_cost.gradients(space, xs[N], u0)
    tLxx, _, _ = problem.term_cost.hessians(space, xs[N], u0)
    tv = problem.term_constraint_values(xs[N])
    tJx = problem.term_constraint_jacobians(xs[N])

    init_res = problem.init_condition_residual(xs[0])
    init_Jx = problem.init_condition_jacobian(xs[0])

    Lx = jnp.concatenate([Lx_s, tLx[None]], axis=0)
    Lxx = jnp.concatenate([Lxx_s, tLxx[None]], axis=0)

    Hxx = Hxu = Huu = None
    if lams is not None:
        Hxx, Hxu, Huu = dynamics_vhp(problem, xs, us, lams[1:])

    return ProblemData(
        cost=jnp.sum(costs) + tc,
        stage_costs=costs,
        term_cost=tc,
        init_res=init_res,
        dyn_res=dyn_res,
        cstr_vals=cstr_vals,
        term_cstr_vals=tv,
        Lx=Lx,
        Lu=Lu,
        Lxx=Lxx,
        Lxu=Lxu,
        Luu=Luu,
        A=A,
        B=B,
        E=E,
        cstr_Jx=cJx,
        cstr_Ju=cJu,
        term_cstr_Jx=tJx,
        init_Jx=init_Jx,
        Hxx=Hxx,
        Hxu=Hxu,
        Huu=Huu,
    )
