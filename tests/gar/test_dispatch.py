"""Kernel choice of the batched LQ solve, and the vmapped XLA path that
medium dims take.

``riccati.use_fused_kernel`` is a pure function of platform, dtype, batch
shape and dims; the custom_vmap rule of ``solve_and_gains`` follows it. The
dispatch tests pretend to be on a GPU and swap the kernel for its
interpret-mode run, so the routing is exercised on the CPU."""

import jax
import jax.numpy as jnp
import pytest

from aligator_tpu import gar
from aligator_tpu.gar import pallas_riccati, riccati

B = pallas_riccati.BLOCK
f32, f64 = jnp.float32, jnp.float64


@pytest.mark.parametrize(
    "platform,dtype,batch_shape,dims,expected",
    [
        ("gpu", f32, (2 * B,), (3, 2, 3, 0), True),
        ("gpu", f32, (B,), (4, 4, 4, 0), True),
        ("cpu", f32, (2 * B,), (3, 2, 3, 0), False),
        ("gpu", f64, (2 * B,), (3, 2, 3, 0), False),
        ("gpu", f32, (2 * B + 8,), (3, 2, 3, 0), False),
        ("gpu", f32, (2, B), (3, 2, 3, 0), False),
        ("gpu", f32, (2 * B,), (5, 2, 5, 0), False),
        ("gpu", f32, (2 * B,), (3, 5, 3, 0), False),
        ("gpu", f32, (2 * B,), (3, 2, 2, 0), False),
        ("gpu", f32, (2 * B,), (3, 2, 3, 1), False),
    ],
)
def test_use_fused_kernel_choice(platform, dtype, batch_shape, dims,
                                 expected):
    nx, nu, nc0, nth = dims
    assert riccati.use_fused_kernel(
        platform, dtype, batch_shape, nx, nu, nc0, nth
    ) is expected


@pytest.fixture
def on_gpu_with_interpreted_kernel(monkeypatch):
    """Report a GPU backend and run the kernel in the interpreter; records
    the batch sizes that reached the kernel."""
    calls = []
    solve = pallas_riccati.solve

    def interpreted(problem, *args, **kwargs):
        calls.append(problem.knots.Q.shape[0])
        return solve(problem, *args, interpret=True, **kwargs)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas_riccati, "solve", interpreted)
    return calls


def _f32_probs(batch, N=4, nx=3, nu=2, nc=1):
    return jax.vmap(
        lambda k: gar.random_convex_problem(k, N, nx, nu, nc, dtype=f32)
    )(jax.random.split(jax.random.PRNGKey(batch), batch))


def _batched(probs):
    return jax.vmap(
        lambda p: riccati.solve_and_gains(p, 1e-2, 1e-2, True)
    )(probs)


def _reference(probs):
    with jax.default_matmul_precision("highest"):
        return jax.vmap(lambda p: gar.solve(p, 1e-2, 1e-2, True))(probs)


def test_dispatch_routes_full_tiles_to_kernel(on_gpu_with_interpreted_kernel):
    probs = _f32_probs(B)
    got = _batched(probs)
    assert on_gpu_with_interpreted_kernel == [B]
    for r, g in zip(_reference(probs), got[:4]):
        assert jnp.allclose(r, g, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("batch", [B - 1, B + 3])
def test_dispatch_partial_tile_stays_on_scan(on_gpu_with_interpreted_kernel,
                                             batch):
    probs = _f32_probs(batch)
    got = _batched(probs)
    assert on_gpu_with_interpreted_kernel == []
    for r, g in zip(_reference(probs), got[:4]):
        assert jnp.allclose(r, g, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dims", [(36, 12, 12), (56, 22, 0)])
def test_vmapped_xla_path_matches_dense(dims):
    """Medium dims (humanoid nx=36, dense LQR nx=56) ride the vmapped XLA
    scan: it must equal the dense KKT solve."""
    nx, nu, nc = dims
    N, batch = 3, 2
    probs = jax.vmap(
        lambda k: gar.random_convex_problem(k, N, nx, nu, nc, dtype=f64)
    )(jax.random.split(jax.random.PRNGKey(nx), batch))
    got = jax.vmap(
        lambda p: riccati.solve_and_gains(p, 1e-3, 1e-3, True)
    )(probs)
    ref = jax.vmap(lambda p: gar.dense_solve(p, 1e-3, 1e-3))(probs)
    for r, g in zip(ref, got[:4]):
        assert jnp.allclose(r, g, atol=1e-7)
