"""Fused Triton Riccati kernel vs the XLA solver.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which executes the same kernel body as the card does; the compiled kernel
is checked by the ``gpu``-marked test below and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import pytest

from aligator_tpu import gar
from aligator_tpu._pytree import replace
from aligator_tpu.gar import pallas_riccati, riccati

B = pallas_riccati.BLOCK


def _probs(N, nx, nu, nc, batch=B, seed=0, general_E=False):
    probs = jax.vmap(
        lambda k: gar.random_problem(k, N, nx, nu, nc, dtype=jnp.float64)
    )(jax.random.split(jax.random.PRNGKey(seed), batch))
    if general_E:
        dE = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 5), probs.knots.E.shape, jnp.float64
        )
        probs = replace(probs, knots=replace(probs.knots, E=probs.knots.E + dE))
    return probs


def _scan(probs, mudyn, mueq, explicit):
    return jax.vmap(
        lambda p, md, me: gar.solve(p, md, me, assume_explicit=explicit),
        in_axes=(0, 0 if jnp.ndim(mudyn) else None,
                 0 if jnp.ndim(mueq) else None),
    )(probs, mudyn, mueq)


@pytest.mark.parametrize("dims", [(10, 3, 2, 1), (15, 4, 2, 0)])
def test_pallas_matches_xla_interpret(dims):
    N, nx, nu, nc = dims
    probs = _probs(N, nx, nu, nc)
    xs_r, us_r, vs_r, lams_r = _scan(probs, 1e-3, 1e-3, True)
    xs_p, us_p, vs_p, lams_p = pallas_riccati.solve(
        probs, 1e-3, 1e-3, interpret=True
    )
    assert jnp.allclose(xs_p, xs_r, atol=1e-9)
    assert jnp.allclose(us_p, us_r, atol=1e-9)
    assert jnp.allclose(vs_p, vs_r, atol=1e-8)
    assert jnp.allclose(lams_p, lams_r, atol=1e-8)


def test_pallas_general_E_interpret():
    """General dynamics E-blocks (manifold difference-chart Jacobians) via
    the kernel's unrolled Gauss-Jordan path."""
    probs = _probs(8, 4, 2, 2, general_E=True)
    ref = _scan(probs, 1e-3, 1e-3, False)
    got = pallas_riccati.solve(
        probs, 1e-3, 1e-3, interpret=True, assume_explicit=False
    )
    for r, g in zip(ref, got):
        assert jnp.allclose(r, g, atol=1e-8)


def test_pallas_gains_and_runtime_mu_interpret():
    """``return_gains`` matches the scan factors (terminal propagation gains
    included); μ is a runtime input, exercised with two values through one
    trace."""
    N = 6
    probs = _probs(N, 3, 2, 1, seed=1)
    run = jax.jit(
        lambda p, md, me: pallas_riccati.solve(
            p, md, me, interpret=True, return_gains=True
        )
    )
    for mudyn, mueq in [(1e-3, 1e-3), (1e-1, 1e-2)]:
        *_, gains = run(probs, jnp.float64(mudyn), jnp.float64(mueq))
        facs = jax.vmap(
            lambda p: riccati.backward(p, mudyn, mueq, True)
        )(probs)
        for name in riccati._GAIN_FIELDS:
            assert jnp.allclose(getattr(facs, name), gains[name],
                                atol=1e-8), name


def test_solve_and_gains_vmap_fallback():
    """The custom_vmap dispatcher: unbatched == scan path; on the CPU the
    rule takes the vmapped-scan path and must equal per-problem solves."""
    batch = 4
    probs = _probs(6, 3, 2, 1, batch=batch, seed=2)
    out_v = jax.vmap(
        lambda p: riccati.solve_and_gains(p, 1e-3, 1e-3)
    )(probs)
    for b in range(batch):
        one = jax.tree.map(lambda a: a[b], probs)
        out_1 = riccati.solve_and_gains(one, 1e-3, 1e-3)
        for rv, r1 in zip(jax.tree.leaves(out_v), jax.tree.leaves(out_1)):
            assert jnp.allclose(rv[b], r1, atol=1e-10)


def test_pallas_availability_gate():
    prob = gar.random_problem(jax.random.PRNGKey(0), 5, 3, 2, 0)
    assert pallas_riccati.covers(prob.nx, prob.nu, prob.nc0, prob.knots.nth)
    big = gar.random_problem(jax.random.PRNGKey(0), 5, 12, 2, 0)
    assert not pallas_riccati.covers(big.nx, big.nu, big.nc0, big.knots.nth)
    partial = gar.random_problem(jax.random.PRNGKey(0), 5, 3, 2, 0, nc0=2)
    assert not pallas_riccati.covers(
        partial.nx, partial.nu, partial.nc0, partial.knots.nth
    )


@pytest.mark.parametrize(
    "nx,nu,nc,explicit",
    [
        (1, 1, 0, True),
        (2, 1, 1, False),
        (3, 3, 3, True),
        (4, 4, 0, False),
        (4, 2, 4, True),
        (2, 3, 2, False),
    ],
)
def test_kernel_matches_scan_dims(nx, nu, nc, explicit):
    """Kernel vs scan over the (nx, nu, nc) range the kernel covers, with
    explicit and general E blocks."""
    probs = _probs(5, nx, nu, nc, seed=nx + 10 * nu + 100 * nc,
                   general_E=not explicit)
    ref = _scan(probs, 1e-2, 1e-3, explicit)
    got = pallas_riccati.solve(probs, 1e-2, 1e-3, interpret=True,
                               assume_explicit=explicit)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert jnp.allclose(r, g, atol=1e-8)


def test_kernel_per_lane_mu_and_tiles():
    """Two tiles of ``BLOCK`` scenarios, each scenario with its own μ (a
    vmapped ProxDDP evolves μ per scenario)."""
    batch = 2 * B
    probs = _probs(4, 3, 2, 1, batch=batch, seed=3)
    mudyn = jnp.geomspace(1e-4, 1e-1, batch)
    mueq = jnp.geomspace(1e-1, 1e-4, batch)
    ref = _scan(probs, mudyn, mueq, True)
    got = pallas_riccati.solve(probs, mudyn, mueq, interpret=True)
    for r, g in zip(ref, got):
        assert jnp.allclose(r, g, atol=1e-8)


def test_kernel_rejects_partial_tile():
    probs = _probs(3, 2, 1, 0, batch=B + 1)
    with pytest.raises(ValueError, match="multiple"):
        pallas_riccati.solve(probs, 1e-3, 1e-3, interpret=True)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu_device):
    """The compiled kernel on the card matches the highest-pinned scan."""
    with jax.default_device(gpu_device):
        probs = jax.tree.map(
            lambda a: a.astype(jnp.float32), _probs(20, 3, 2, 1)
        )
        with jax.default_matmul_precision("highest"):
            ref = _scan(probs, 1e-3, 1e-3, True)
        got = jax.jit(
            lambda p: pallas_riccati.solve(p, 1e-3, 1e-3)
        )(probs)
    for r, g in zip(ref, got):
        scale = float(jnp.abs(r).max()) + 1e-30
        assert float(jnp.abs(r - g).max()) / scale < 1e-3
