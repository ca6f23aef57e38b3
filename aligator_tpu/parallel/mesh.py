"""Device-mesh helpers for multi-chip scaling.

The reference's parallelism is shared-memory OpenMP (SURVEY.md §5.8); the
replacement here is SPMD over a `jax.sharding.Mesh` with two natural axes
(the cards of one host are joined all to all, so the meshes are flat):

* ``batch`` — embarrassingly parallel scenarios (MPC instances); sharded
  data-parallel, no collectives in the solve itself.
* ``time`` — the horizon, for parallel-in-time Riccati legs (the condensed
  interface system is small and is resolved with collectives).

``batched_solve`` is the one-call entry point: build a mesh over all local
(or provided) devices, shard a batch of initial states, and run a jitted
vmapped solver.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices: Optional[Sequence] = None, axis_names=("batch",), shape=None
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) if len(axis_names) == 1 else None
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names=axis_names)


def shard_batch(mesh: Mesh, tree, axis_name: str = "batch"):
    """Place a pytree with a leading batch axis onto the mesh, sharded."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tree, sharding)


def batched_solve(
    solve_one: Callable,
    batch_args,
    mesh: Optional[Mesh] = None,
    axis_name="batch",
):
    """Shard ``batch_args`` (leading batch axis) over the mesh and run
    ``vmap(solve_one)`` on each device's shard.

    The per-device program is ``shard_map`` of the vmapped solve, so each
    device runs exactly the single-device batched program on its local
    shard — including any fused kernel the batched solve dispatches to,
    which the SPMD partitioner could not split. Returns the results pytree,
    sharded along the batch axis. The scenarios are independent, so there
    are no collectives.
    """
    if mesh is None:
        mesh = make_mesh()
    spec = P(axis_name)
    sharding = NamedSharding(mesh, spec)
    batch_args = jax.device_put(batch_args, sharding)
    fn = jax.jit(
        jax.shard_map(jax.vmap(solve_one), mesh=mesh, in_specs=spec,
                      out_specs=spec, check_vma=False),
        out_shardings=sharding,
    )
    return fn(batch_args)
