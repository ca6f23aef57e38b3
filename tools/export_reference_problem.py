#!/usr/bin/env python
"""Export a reference (C++) aligator problem to the interchange format.

RUN THIS UNDER THE REFERENCE'S OWN PYTHON ENVIRONMENT (``import aligator``
must resolve to the reference bindings) — it has NO dependency on
``aligator_tpu``.  The output ``.npz`` archives load into this framework
with ``aligator_tpu.utils.interchange.load_problem``, giving the
apples-to-apples parity harness: the identical instance, produced by the
reference's own objects, solved by both implementations.

Covers the interchange-v1 component registry (quadratic costs,
state/control-error residual costs, linear discrete dynamics,
control-error/state-error/linear constraint functions, equality /
negative-orthant / box sets).  Binding attribute names are taken from the
reference binding sources:

* ``QuadraticCost.w_x/w_u/weights_cross`` —
  bindings/python/src/expose-costs.cpp:55-61
* ``QuadraticResidualCost.residual/.weights``, ``QuadStateCost.target`` —
  bindings/python/src/modelling/expose-composite-costs.cpp:35-93
* ``LinearDiscreteDynamics.A/B/c`` — bindings expose the dynamics data
  members (expose-dynamics.cpp)
* stages / components via ``problem.stages[i].cost/dynamics/constraints``

Usage::

    python tools/export_reference_problem.py out.npz  # builds+exports the
                                                      # examples/lqr.py LQR
    # or, from another script under the reference env:
    from export_reference_problem import export_problem
    export_problem(problem, "out.npz", nsteps=len(problem.stages))
"""

import json
import sys

import numpy as np


class _Pool:
    def __init__(self):
        self.arrays = {}
        self._n = 0

    def put(self, a, hint):
        name = f"{hint}_{self._n}"
        self._n += 1
        self.arrays[name] = np.asarray(a, dtype=np.float64)
        return "@" + name


def _space_spec(space):
    tname = type(space).__name__
    if "VectorSpace" in tname:
        return {"type": "vector", "n": int(space.nx)}
    if "SE2" in tname:
        return {"type": "se2"}
    raise NotImplementedError(f"space {tname}")


def _cost_entries(cost, pool):
    import aligator

    tname = type(cost).__name__
    if isinstance(cost, aligator.CostStack):
        out = []
        for comp in cost.components:
            out.extend(_cost_entries(comp, pool))
        return out
    if isinstance(cost, aligator.QuadraticCost):
        nx, nu = cost.w_x.shape[0], cost.w_u.shape[0]
        N = (
            np.asarray(cost.weights_cross)
            if cost.has_cross_term
            else np.zeros((nx, nu))
        )
        return [
            {
                "type": "quadratic",
                "Q": pool.put(cost.w_x, "Q"),
                "R": pool.put(cost.w_u, "R"),
                "N": pool.put(N, "N"),
                "q": pool.put(np.zeros(nx), "q"),
                "r": pool.put(np.zeros(nu), "r"),
                "c": pool.put(np.zeros(()), "c"),
            }
        ]
    if "QuadraticStateCost" in tname:
        return [
            {
                "type": "quad_state",
                "target": pool.put(cost.target, "xtar"),
                "weights": pool.put(cost.weights, "wx"),
            }
        ]
    if "QuadraticControlCost" in tname:
        return [
            {
                "type": "quad_control",
                "target": pool.put(cost.target, "utar"),
                "weights": pool.put(cost.weights, "wu"),
            }
        ]
    raise NotImplementedError(f"cost {tname}")


def _dynamics_spec(dyn, pool):
    tname = type(dyn).__name__
    if "LinearDiscreteDynamics" in tname:
        return {
            "type": "linear_discrete",
            "A": pool.put(dyn.A, "dynA"),
            "B": pool.put(dyn.B, "dynB"),
            "c": pool.put(dyn.c, "dync"),
        }
    # IntegratorEuler over the se2-car CarDynamics (examples/se2-car.hpp)
    if "IntegratorEuler" in tname and "Car" in type(
        getattr(dyn, "differential_dynamics", dyn)
    ).__name__:
        return {
            "type": "se2_car_euler",
            "timestep": float(dyn.timestep),
        }
    raise NotImplementedError(f"dynamics {tname}")


def _function_spec(fn, pool):
    tname = type(fn).__name__
    if "ControlErrorResidual" in tname:
        return {"type": "control_error", "target": pool.put(fn.target, "utar")}
    if "StateErrorResidual" in tname:
        return {"type": "state_error", "target": pool.put(fn.target, "xtar")}
    if "LinearFunction" in tname:
        return {
            "type": "linear",
            "A": pool.put(fn.A, "cA"),
            "B": pool.put(fn.B, "cB"),
            "c": pool.put(fn.d, "cc"),
        }
    raise NotImplementedError(f"function {tname}")


def _set_spec(cset, pool):
    tname = type(cset).__name__
    if "Equality" in tname:
        return {"type": "equality"}
    if "NegativeOrthant" in tname:
        return {"type": "negative_orthant"}
    if "BoxConstraint" in tname:
        return {
            "type": "box",
            "lower": pool.put(cset.lower_limit, "lo"),
            "upper": pool.put(cset.upper_limit, "hi"),
        }
    raise NotImplementedError(f"set {tname}")


def export_problem(problem, path, nsteps=None):
    """Export a reference ``aligator.TrajOptProblem`` to ``path``.

    Assumes stage-homogeneous problems (the interchange loader replicates
    one stage; per-stage cost arrays may differ — they are stacked)."""
    pool = _Pool()
    stages = list(problem.stages)
    if nsteps is None:
        nsteps = len(stages)
    st0 = stages[0]

    cost_entries = _cost_entries(st0.cost, pool)
    constraints = []
    ncstr = getattr(st0, "num_constraints", len(getattr(st0, "constraints", [])))
    for k in range(ncstr):
        f = st0.constraints.funcs[k] if hasattr(st0.constraints, "funcs") \
            else st0.constraints[k].func
        s = st0.constraints.sets[k] if hasattr(st0.constraints, "sets") \
            else st0.constraints[k].set
        constraints.append(
            {"function": _function_spec(f, pool), "set": _set_spec(s, pool)}
        )

    term_constraints = []
    tc = getattr(problem, "term_constraints", [])
    for k in range(getattr(tc, "size", len(tc))):
        f = tc.funcs[k] if hasattr(tc, "funcs") else tc[k].func
        s = tc.sets[k] if hasattr(tc, "sets") else tc[k].set
        term_constraints.append(
            {"function": _function_spec(f, pool), "set": _set_spec(s, pool)}
        )

    manifest = {
        "format": "aligator-interchange-v1",
        "nsteps": int(nsteps),
        "nu": int(st0.nu),
        "space": _space_spec(st0.xspace if hasattr(st0, "xspace") else st0.space),
        "x0": pool.put(problem.x0_init, "x0"),
        "dynamics": _dynamics_spec(st0.dynamics, pool),
        "cost": cost_entries,
        "term_cost": _cost_entries(problem.term_cost, pool),
        "constraints": constraints,
        "term_constraints": term_constraints,
    }
    np.savez(path, manifest=np.asarray(json.dumps(manifest)), **pool.arrays)
    print(f"exported {path}")


def _build_example_lqr():
    """Rebuild examples/lqr.py:33-75 under the reference env."""
    import aligator
    from aligator import dynamics, manifolds

    nx = nu = 3
    space = manifolds.VectorSpace(nx)
    x0 = space.neutral() + (0.2, 0.3, -0.1)
    A = np.eye(nx)
    A[0, 1] = -0.2
    A[1, 0] = 0.2
    B = np.eye(nx)[:, :nu]
    B[2, :] = 0.4
    c = np.zeros(nx)
    c[:] = (0.0, 0.0, 0.1)
    Q = 1e-2 * np.eye(nx)
    R = 1e-2 * np.eye(nu)
    N = 1e-5 * np.eye(nx, nu)
    Qf = np.eye(nx)
    rcost0 = aligator.QuadraticCost(Q, R, N)
    term_cost = aligator.QuadraticCost(Qf, R)
    dynmodel = dynamics.LinearDiscreteDynamics(A, B, c)
    stage = aligator.StageModel(rcost0, dynmodel)
    nsteps = 20
    problem = aligator.TrajOptProblem(x0, nu, space, term_cost)
    for _ in range(nsteps):
        problem.addStage(stage)
    return problem


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "ref_lqr_exported.npz"
    export_problem(_build_example_lqr(), out)
