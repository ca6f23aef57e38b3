"""Problem interchange: a serialized problem format + loader/saver.

The compat-layer role (reference layer 5,
``include/aligator/compat/crocoddyl/problem-wrap.hpp:14``
``ActionModelWrapperTpl``): the reference can ingest externally defined
problems; this module gives this framework the same *capability* through
a neutral serialized format instead of a C++ ABI bridge — a single ``.npz``
archive holding a JSON manifest plus the referenced arrays.  Any producer
(this framework, an exporter script running under the reference's own
Python environment — ``tools/export_reference_problem.py`` — or a hand
transcription of a published problem definition) can emit the format; the
loader reconstructs a native :class:`TrajOptProblem`, which is also the
apples-to-apples parity harness: the SAME imported instance solved by the
JAX solver, the independent NumPy oracle, and (under its own env) the
reference itself.

Format v1 (``aligator-interchange-v1``):

* manifest (JSON, stored under the ``manifest`` key):
  ``{"format", "nsteps", "nu", "space", "x0", "dynamics", "cost",
  "term_cost", "constraints", "term_constraints"}``
* array references are strings ``"@name"`` resolving into the archive;
  scalars may be inlined.
* spaces: ``vector`` (n) | ``se2``
* dynamics: ``linear_discrete`` (A, B, c) | ``se2_car_euler`` (timestep —
  the reference ``examples/se2-car.hpp:33-61`` unicycle, Euler-integrated)
* costs (lists; >1 entry becomes a :class:`CostStack`):
  ``quadratic`` (Q, R, N, q, r, c) | ``quad_state`` (target, weights) |
  ``quad_control`` (weights, target)
* constraint functions: ``control_error`` (target) | ``state_error``
  (target) | ``linear`` (A, B, c); sets: ``equality`` |
  ``negative_orthant`` | ``box`` (lower, upper)

Stage-varying data: any stage-cost/constraint array may carry a leading
time axis of size ``nsteps`` — the loader broadcasts the stage pytree and
substitutes the stacked leaf (the framework's native heterogeneity model).

The gar level has its own pair :func:`save_lqr` / :func:`load_lqr` for raw
:class:`LQRProblem` knot arrays — the densest possible interchange (the
reference's gar benchmarks serialize exactly these arrays).
"""

from __future__ import annotations

import json

import numpy as np

import jax.numpy as jnp

from .._pytree import replace
from ..core import (
    BoxConstraint,
    CostStack,
    EqualityConstraint,
    LinearFunction,
    NegativeOrthant,
    QuadraticCost,
    QuadraticControlCost,
    QuadraticStateCost,
    make_problem,
    make_stage,
    replicate_stage,
)
from ..core.dynamics import LinearDiscreteDynamics
from ..core.functions import ControlErrorResidual, StateErrorResidual
from ..core.manifolds import VectorSpace
from ..core.problem import TrajOptProblem
from ..gar.lqr_problem import LQRKnots, LQRProblem

FORMAT = "aligator-interchange-v1"


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


class _ArrayPool:
    def __init__(self):
        self.arrays = {}
        self._n = 0

    def put(self, a, hint):
        name = f"{hint}_{self._n}"
        self._n += 1
        self.arrays[name] = np.asarray(a)
        return "@" + name


def _space_spec(space):
    from ..modelling.spaces.se2 import SE2

    if isinstance(space, VectorSpace):
        return {"type": "vector", "n": int(space.nx)}
    if isinstance(space, SE2):
        return {"type": "se2"}
    raise NotImplementedError(
        f"interchange-v1 cannot serialize space {type(space).__name__}"
    )


def _cost_entries(cost, pool):
    if isinstance(cost, CostStack):
        out = []
        for c in cost.costs:
            out.extend(_cost_entries(c, pool))
        return out
    if isinstance(cost, QuadraticCost):
        return [
            {
                "type": "quadratic",
                "Q": pool.put(cost.Q, "Q"),
                "R": pool.put(cost.R, "R"),
                "N": pool.put(cost.N, "N"),
                "q": pool.put(cost.q, "q"),
                "r": pool.put(cost.r, "r"),
                "c": pool.put(cost.c, "c"),
            }
        ]
    # QuadraticResidualCost over state/control error residuals
    from ..core.costs import QuadraticResidualCost

    if isinstance(cost, QuadraticResidualCost):
        res = cost.residual
        if isinstance(res, StateErrorResidual):
            return [
                {
                    "type": "quad_state",
                    "target": pool.put(res.target, "xtar"),
                    "weights": pool.put(cost.weights, "wx"),
                }
            ]
        if isinstance(res, ControlErrorResidual):
            return [
                {
                    "type": "quad_control",
                    "target": pool.put(res.target, "utar"),
                    "weights": pool.put(cost.weights, "wu"),
                }
            ]
    raise NotImplementedError(
        f"interchange-v1 cannot serialize cost {type(cost).__name__}"
    )


def _function_spec(fn, pool):
    if isinstance(fn, ControlErrorResidual):
        return {"type": "control_error", "target": pool.put(fn.target, "utar")}
    if isinstance(fn, StateErrorResidual):
        return {"type": "state_error", "target": pool.put(fn.target, "xtar")}
    if isinstance(fn, LinearFunction):
        return {
            "type": "linear",
            "A": pool.put(fn.A, "cA"),
            "B": pool.put(fn.B, "cB"),
            "c": pool.put(fn.c, "cc"),
        }
    raise NotImplementedError(
        f"interchange-v1 cannot serialize function {type(fn).__name__}"
    )


def _set_spec(cset, pool):
    if isinstance(cset, EqualityConstraint):
        return {"type": "equality"}
    if isinstance(cset, NegativeOrthant):
        return {"type": "negative_orthant"}
    if isinstance(cset, BoxConstraint):
        return {
            "type": "box",
            "lower": pool.put(cset.lower, "lo"),
            "upper": pool.put(cset.upper, "hi"),
        }
    raise NotImplementedError(
        f"interchange-v1 cannot serialize set {type(cset).__name__}"
    )


def save_problem(path, problem: TrajOptProblem):
    """Serialize a :class:`TrajOptProblem` to ``path`` (.npz).

    Supports the v1 component registry (see module docstring); raises
    ``NotImplementedError`` on components outside it.  Stage-varying
    (stacked) leaves are stored with their leading time axis and restored
    as stacked stage parameters by :func:`load_problem`."""
    pool = _ArrayPool()
    N = problem.nsteps
    stage0 = problem.stage_at(0)

    dyn = stage0.dynamics
    from examples.se2_car import CarDynamics  # registry entry for se2 car
    from ..modelling.dynamics.ode import IntegratorEuler

    if isinstance(dyn, LinearDiscreteDynamics):
        dspec = {
            "type": "linear_discrete",
            "A": pool.put(dyn.A, "dynA"),
            "B": pool.put(dyn.B, "dynB"),
            "c": pool.put(dyn.c, "dync"),
        }
    elif isinstance(dyn, IntegratorEuler) and isinstance(
        dyn.ode, CarDynamics
    ):
        dspec = {
            "type": "se2_car_euler",
            "timestep": float(dyn.timestep),
        }
    else:
        raise NotImplementedError(
            f"interchange-v1 cannot serialize dynamics {type(dyn).__name__}"
        )

    # detect stacked stage leaves: serialize the STACKED stage cost arrays
    # when they differ across stages
    stacked_cost = problem.stages.cost
    cost_entries = _cost_entries(stacked_cost, _ArrayPool())  # structure only
    pool2 = _ArrayPool()
    stage_costs = _cost_entries_stacked(
        problem, stacked_cost, cost_entries, pool2
    )
    pool.arrays.update(pool2.arrays)
    pool._n += pool2._n

    manifest = {
        "format": FORMAT,
        "nsteps": N,
        "nu": int(problem.nu),
        "space": _space_spec(problem.space),
        "x0": pool.put(problem.x0, "x0"),
        "dynamics": dspec,
        "cost": stage_costs,
        "term_cost": _cost_entries(problem.term_cost, pool),
        "constraints": [
            {
                "function": _function_spec(f, pool),
                "set": _set_spec(s, pool),
            }
            for f, s in stage0.constraints
        ],
        "term_constraints": [
            {
                "function": _function_spec(f, pool),
                "set": _set_spec(s, pool),
            }
            for f, s in problem.term_constraints
        ],
    }
    np.savez(
        path, manifest=np.asarray(json.dumps(manifest)), **pool.arrays
    )


def _cost_entries_stacked(problem, stacked_cost, entries, pool):
    """Serialize the (possibly stage-stacked) cost arrays: each leaf is
    stored stage-constant when all stages share the value, stacked (leading
    N axis) otherwise."""
    N = problem.nsteps

    def put_maybe_stacked(arr, hint):
        a = np.asarray(arr)
        if a.ndim >= 1 and a.shape[0] == N:
            first = a[0]
            if np.all(a == first[None]):
                return pool.put(first, hint)
            return pool.put(a, hint)  # genuinely stage-varying
        return pool.put(a, hint)

    from ..core.costs import QuadraticResidualCost

    def walk(cost):
        if isinstance(cost, CostStack):
            out = []
            for c in cost.costs:
                out.extend(walk(c))
            return out
        if isinstance(cost, QuadraticCost):
            return [
                {
                    "type": "quadratic",
                    **{
                        k: put_maybe_stacked(getattr(cost, k), k)
                        for k in ("Q", "R", "N", "q", "r", "c")
                    },
                }
            ]
        if isinstance(cost, QuadraticResidualCost):
            res = cost.residual
            if isinstance(res, StateErrorResidual):
                return [
                    {
                        "type": "quad_state",
                        "target": put_maybe_stacked(res.target, "xtar"),
                        "weights": put_maybe_stacked(cost.weights, "wx"),
                    }
                ]
            if isinstance(res, ControlErrorResidual):
                return [
                    {
                        "type": "quad_control",
                        "target": put_maybe_stacked(res.target, "utar"),
                        "weights": put_maybe_stacked(cost.weights, "wu"),
                    }
                ]
        raise NotImplementedError(type(cost).__name__)

    return walk(stacked_cost)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def _resolve(ref, arrays, dtype):
    if isinstance(ref, str) and ref.startswith("@"):
        return jnp.asarray(arrays[ref[1:]], dtype)
    return jnp.asarray(ref, dtype)


def _build_space(spec):
    from ..modelling.spaces.se2 import SE2

    if spec["type"] == "vector":
        return VectorSpace(spec["n"])
    if spec["type"] == "se2":
        return SE2()
    raise ValueError(f"unknown space type {spec['type']}")


def _build_cost(entries, arrays, dtype, nsteps):
    """Build (cost, stacked_updates): stage-constant cost pytree + a list
    of (path, stacked_array) substitutions for genuinely stage-varying
    leaves."""
    costs = []
    stacked = []  # (cost_index, field_path, array)

    def get(ref, expect_stage_dim_of=None):
        a = _resolve(ref, arrays, dtype)
        return a

    for idx, e in enumerate(entries):
        t = e["type"]
        if t == "quadratic":
            vals = {k: get(e[k]) for k in ("Q", "R", "N", "q", "r", "c")}
            base_ndim = {"Q": 2, "R": 2, "N": 2, "q": 1, "r": 1, "c": 0}
            const = {}
            for k, v in vals.items():
                if v.ndim == base_ndim[k] + 1 and v.shape[0] == nsteps:
                    stacked.append((idx, (k,), v))
                    const[k] = v[0]
                else:
                    const[k] = v
            costs.append(QuadraticCost(**const))
        elif t == "quad_state":
            tgt = get(e["target"])
            w = get(e["weights"])
            if tgt.ndim == 2 and tgt.shape[0] == nsteps:
                stacked.append((idx, ("residual", "target"), tgt))
                tgt = tgt[0]
            if w.ndim == 3 and w.shape[0] == nsteps:
                stacked.append((idx, ("weights",), w))
                w = w[0]
            costs.append(QuadraticStateCost(tgt, w))
        elif t == "quad_control":
            tgt = get(e["target"])
            w = get(e["weights"])
            if tgt.ndim == 2 and tgt.shape[0] == nsteps:
                stacked.append((idx, ("residual", "target"), tgt))
                tgt = tgt[0]
            if w.ndim == 3 and w.shape[0] == nsteps:
                stacked.append((idx, ("weights",), w))
                w = w[0]
            costs.append(QuadraticControlCost(w, tgt))
        else:
            raise ValueError(f"unknown cost type {t}")
    if len(costs) == 1 and not stacked:
        return costs[0], []
    return CostStack.create(*costs), stacked


def _build_function(spec, arrays, dtype):
    t = spec["type"]
    if t == "control_error":
        return ControlErrorResidual(target=_resolve(spec["target"], arrays, dtype))
    if t == "state_error":
        return StateErrorResidual(target=_resolve(spec["target"], arrays, dtype))
    if t == "linear":
        return LinearFunction(
            A=_resolve(spec["A"], arrays, dtype),
            B=_resolve(spec["B"], arrays, dtype),
            c=_resolve(spec["c"], arrays, dtype),
        )
    raise ValueError(f"unknown function type {t}")


def _build_set(spec, arrays, dtype):
    t = spec["type"]
    if t == "equality":
        return EqualityConstraint()
    if t == "negative_orthant":
        return NegativeOrthant()
    if t == "box":
        return BoxConstraint(
            lower=_resolve(spec["lower"], arrays, dtype),
            upper=_resolve(spec["upper"], arrays, dtype),
        )
    raise ValueError(f"unknown set type {t}")


def load_problem(path, dtype=jnp.float64) -> TrajOptProblem:
    """Load a serialized problem into a native :class:`TrajOptProblem`."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(str(arrays.pop("manifest")))
    if manifest["format"] != FORMAT:
        raise ValueError(f"unknown format {manifest['format']}")
    N = manifest["nsteps"]
    nu = manifest["nu"]
    space = _build_space(manifest["space"])
    x0 = _resolve(manifest["x0"], arrays, dtype)

    dspec = manifest["dynamics"]
    if dspec["type"] == "linear_discrete":
        dyn = LinearDiscreteDynamics(
            A=_resolve(dspec["A"], arrays, dtype),
            B=_resolve(dspec["B"], arrays, dtype),
            c=_resolve(dspec["c"], arrays, dtype),
        )
    elif dspec["type"] == "se2_car_euler":
        from examples.se2_car import CarDynamics
        from ..modelling.dynamics.ode import IntegratorEuler

        dyn = IntegratorEuler(
            ode=CarDynamics(),
            timestep=jnp.asarray(dspec["timestep"], dtype),
        )
    else:
        raise ValueError(f"unknown dynamics type {dspec['type']}")

    cost, stacked = _build_cost(manifest["cost"], arrays, dtype, N)
    term_cost, t_stacked = _build_cost(
        manifest["term_cost"], arrays, dtype, N
    )
    if t_stacked:
        raise ValueError("terminal cost cannot be stage-stacked")

    constraints = tuple(
        (
            _build_function(c["function"], arrays, dtype),
            _build_set(c["set"], arrays, dtype),
        )
        for c in manifest["constraints"]
    )
    term_constraints = tuple(
        (
            _build_function(c["function"], arrays, dtype),
            _build_set(c["set"], arrays, dtype),
        )
        for c in manifest["term_constraints"]
    )

    stage = make_stage(cost, dyn, space, nu, constraints)
    stages = None
    if stacked:
        stages = replicate_stage(stage, N)
        for idx, path_, arr in stacked:
            stages = _substitute_cost_leaf(stages, idx, path_, arr)
    return make_problem(
        x0, stage, N, term_cost,
        term_constraints=term_constraints, stages=stages,
    )


def _substitute_cost_leaf(stages, cost_idx, field_path, arr):
    """Replace one stacked leaf of stage cost #cost_idx along field_path."""
    cost = stages.cost
    target = cost.costs[cost_idx] if isinstance(cost, CostStack) else cost

    def set_path(obj, path_, value):
        if len(path_) == 1:
            return replace(obj, **{path_[0]: value})
        child = getattr(obj, path_[0])
        return replace(obj, **{path_[0]: set_path(child, path_[1:], value)})

    new_target = set_path(target, field_path, arr)
    if isinstance(cost, CostStack):
        new_costs = tuple(
            new_target if i == cost_idx else c
            for i, c in enumerate(cost.costs)
        )
        new_cost = replace(cost, costs=new_costs)
    else:
        new_cost = new_target
    return replace(stages, cost=new_cost)


# ---------------------------------------------------------------------------
# gar-level LQ interchange
# ---------------------------------------------------------------------------

_LQR_FIELDS = ("Q", "S", "R", "q", "r", "A", "B", "E", "f", "C", "D", "d")
_LQR_TH_FIELDS = ("Gx", "Gu", "Gth", "gamma")


def save_lqr(path, problem: LQRProblem):
    """Serialize a gar :class:`LQRProblem` (knot arrays + G0/g0)."""
    out = {k: np.asarray(getattr(problem.knots, k)) for k in _LQR_FIELDS}
    for k in _LQR_TH_FIELDS:
        v = getattr(problem.knots, k)
        if v is not None:
            out[k] = np.asarray(v)
    out["G0"] = np.asarray(problem.G0)
    out["g0"] = np.asarray(problem.g0)
    np.savez(path, format=np.asarray("aligator-lqr-v1"), **out)


def load_lqr(path, dtype=jnp.float64) -> LQRProblem:
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if str(arrays.pop("format")) != "aligator-lqr-v1":
        raise ValueError("not an aligator-lqr-v1 archive")
    kn = {
        k: jnp.asarray(arrays[k], dtype)
        for k in _LQR_FIELDS + _LQR_TH_FIELDS
        if k in arrays
    }
    return LQRProblem(
        knots=LQRKnots(**kn),
        G0=jnp.asarray(arrays["G0"], dtype),
        g0=jnp.asarray(arrays["g0"], dtype),
    )
