"""Mesh helpers on the virtual 8-device CPU mesh (conftest forces
``--xla_force_host_platform_device_count=8``): flat batch sharding and
sharded-vs-local equality of ``batched_solve`` (reference §5.8 analog —
the OpenMP layer)."""

import jax
import jax.numpy as jnp

from aligator_tpu import gar, solvers
from aligator_tpu._pytree import replace
from aligator_tpu.parallel import mesh as mesh_mod


def _solve_one(problem):
    def one(x0g):
        p = replace(problem, g0=x0g)
        xs, us, vs, lams = gar.solve(p, 1e-3, 1e-3, assume_explicit=True)
        return us

    return one


def test_batched_solve_matches_local():
    prob = gar.random_problem(jax.random.PRNGKey(0), 10, 4, 2, 1, dtype=jnp.float64)
    B = 16
    g0s = jax.random.normal(jax.random.PRNGKey(1), (B, 4), jnp.float64)
    one = _solve_one(prob)
    m = mesh_mod.make_mesh()
    assert m.devices.size == 8
    out = mesh_mod.batched_solve(one, g0s, mesh=m)
    ref = jax.vmap(one)(g0s)
    assert jnp.allclose(out, ref, atol=1e-10)


def test_time_sharded_parallel_riccati_medium_dims():
    """Parallel-in-time leg solve with the LEG AXIS sharded over the mesh at
    medium dims (nx=36, nu=12 — the reference gar bench shape,
    bench/gar-riccati.cpp:18), where the condensed-system collectives carry
    nx*nx blocks: result matches the serial sweep (VERDICT r2 item 9)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import numpy as np

    from aligator_tpu.gar import parallel as gar_parallel
    from aligator_tpu.gar import riccati

    N, nx, nu = 31, 36, 12
    # jointly convex stage costs — the parallel kernel's operating domain
    # (what ProxDDP emits; see gar.random_convex_problem docstring)
    prob = gar.random_convex_problem(
        jax.random.PRNGKey(5), N, nx, nu, 0, dtype=jnp.float64
    )
    mesh = Mesh(np.array(jax.devices()), axis_names=("time",))
    tsh = NamedSharding(mesh, P("time"))
    xs, us, vs, lams = jax.jit(
        lambda p: gar_parallel.solve(
            p, 1e-3, 1e-3, legs=8, assume_explicit=True, time_sharding=tsh
        )
    )(prob)
    xr, ur, vr, lr = riccati.solve(prob, 1e-3, 1e-3, True)
    assert jnp.allclose(xs, xr, atol=1e-8)
    assert jnp.allclose(us, ur, atol=1e-8)
    assert jnp.allclose(lams, lr, atol=1e-8)


def test_proxddp_sharded_solve():
    """End-to-end ProxDDP under the mesh: sharded batch equals local."""
    from examples.lqr import make_lqr_problem

    problem = make_lqr_problem(nsteps=12)
    cfg = solvers.ProxDDPConfig(tol=1e-8, mu_init=1e-3, max_iters=6)
    nx = problem.x0.shape[0]
    B = 8
    x0s = problem.x0 + 0.1 * jax.random.normal(jax.random.PRNGKey(4), (B, nx))

    def one(x0):
        return solvers.solve(replace(problem, x0=x0), cfg).us

    m = mesh_mod.make_mesh()
    out = mesh_mod.batched_solve(one, x0s, mesh=m)
    ref = jax.vmap(one)(x0s)
    assert jnp.allclose(out, ref, atol=1e-8)


def test_shard_map_legs_matches_serial_and_collectives():
    """shard_map parallel-in-time legs (round-5 VERDICT item 6):

    1. correctness — ``gar.parallel.solve_sharded`` on the 8-device mesh
       equals the serial sweep;
    2. comm pattern — the compiled HLO contains EXACTLY ONE all-gather
       whose payload matches the comm audit's interface count
       (4·nx² + 2·nx floats per leg) and no other collectives; a silent
       XLA repartition would break this assertion (the weakness of the
       hint-based ``with_sharding_constraint`` path)."""
    import re

    from jax.sharding import Mesh
    import numpy as np

    from aligator_tpu.gar import parallel as gar_parallel
    from aligator_tpu.gar import riccati

    T, nx, nu = 32, 6, 3  # T divisible by 8 legs
    prob = gar.random_convex_problem(
        jax.random.PRNGKey(7), T - 1, nx, nu, 0, dtype=jnp.float64
    )
    mesh = Mesh(np.array(jax.devices()), axis_names=("t",))

    fn = lambda p: gar_parallel.solve_sharded(  # noqa: E731
        p, 1e-3, 1e-3, mesh=mesh, axis_name="t", assume_explicit=True
    )
    xs, us, vs, lams = fn(prob)
    xr, ur, vr, lr = riccati.solve(prob, 1e-3, 1e-3, True)
    assert jnp.allclose(xs, xr, atol=1e-8)
    assert jnp.allclose(us, ur, atol=1e-8)
    assert jnp.allclose(lams, lr, atol=1e-8)

    hlo = jax.jit(fn).lower(prob).compile().as_text()
    # collective census: one all-gather, nothing else
    n_ag = len(re.findall(r"all-gather(?:-start)?\(", hlo))
    assert n_ag == 1, f"expected exactly 1 all-gather, found {n_ag}"
    assert "all-reduce" not in hlo
    assert "collective-permute" not in hlo
    assert "reduce-scatter" not in hlo
    assert "all-to-all" not in hlo
    # payload size: 4*nx^2 + 2*nx floats per leg, gathered over 8 legs
    payload = 4 * nx * nx + 2 * nx
    pat = rf"all-gather(?:-start)?\([^)]*f64\[8,{payload}\]|f64\[8,{payload}\][^\n]*all-gather"
    assert re.search(pat, hlo), (
        f"all-gather payload f64[8,{payload}] not found in HLO"
    )
