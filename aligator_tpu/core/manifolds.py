"""Manifold (Lie-group) interface.

Accelerator-native counterpart of ``ManifoldAbstractTpl`` (reference
``include/aligator/core/manifold-base.hpp:11``). Manifolds are *static*
hashable Python objects (they carry no arrays), so they can live in pytree
metadata and be closed over by jitted functions. All operations are pure
functions of arrays; Jacobians default to (exact) forward-mode autodiff in
tangent coordinates, with closed-form overrides where profitable.

Convention (matches the reference / pinocchio):
  ``difference(x0, x1) = x1 ⊖ x0``  (tangent vector at x0 taking x0 to x1)
  ``integrate(x, v) = x ⊕ v``
  ``Jintegrate/Jdifference(·, ·, arg)`` differentiate wrt argument ``arg``
  in *tangent* coordinates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class Manifold:
    """Abstract manifold. Subclasses define nx/ndx/neutral/integrate/difference."""

    nx: int
    ndx: int

    # -- core ops ---------------------------------------------------------
    def neutral(self) -> jax.Array:
        raise NotImplementedError

    def rand(self, key) -> jax.Array:
        raise NotImplementedError

    def integrate(self, x, v) -> jax.Array:
        raise NotImplementedError

    def difference(self, x0, x1) -> jax.Array:
        raise NotImplementedError

    def interpolate(self, x0, x1, t):
        return self.integrate(x0, t * self.difference(x0, x1))

    def is_normalized(self, x) -> jax.Array:
        return jnp.asarray(True)

    def tangent_space(self) -> "VectorSpace":
        return VectorSpace(self.ndx)

    # -- Jacobians (tangent-space, autodiff defaults) ---------------------
    def jintegrate(self, x, v, arg: int) -> jax.Array:
        """d/d(arg) of ``integrate(x ⊕ dx, v + dv)`` in tangent coords at 0."""
        if arg == 0:
            fn = lambda dx: self.difference(
                self.integrate(x, v), self.integrate(self.integrate(x, dx), v)
            )
        else:
            fn = lambda dv: self.difference(
                self.integrate(x, v), self.integrate(x, v + dv)
            )
        z = jnp.zeros((self.ndx,), jnp.result_type(x))
        return jax.jacfwd(fn)(z)

    def jdifference(self, x0, x1, arg: int) -> jax.Array:
        """d/d(arg) of ``difference(x0 ⊕ d0, x1 ⊕ d1)`` in tangent coords at 0."""
        if arg == 0:
            fn = lambda d0: self.difference(self.integrate(x0, d0), x1)
        else:
            fn = lambda d1: self.difference(x0, self.integrate(x1, d1))
        z = jnp.zeros((self.ndx,), jnp.result_type(x0))
        return jax.jacfwd(fn)(z)

    def jintegrate_transport(self, x, v, J, arg: int):
        """Parallel-transport rows of J along integrate (reference
        ``JintegrateTransport``): J ← J @ Jintegrate(x, v, arg)^{-1}... the
        reference uses the right-translation map; default composes with the
        integrate Jacobian."""
        Ji = self.jintegrate(x, v, arg)
        return J @ Ji

    # Manifolds are static metadata: identity-based hash/eq is fine for
    # stateless singletons; subclasses with parameters override __eq__/__hash__.
    def __repr__(self):
        return f"{type(self).__name__}(nx={self.nx}, ndx={self.ndx})"


class VectorSpace(Manifold):
    """Euclidean space R^n (reference ``core/vector-space.hpp:13``)."""

    def __init__(self, n: int):
        self.nx = n
        self.ndx = n

    def neutral(self):
        return jnp.zeros((self.nx,))

    def rand(self, key):
        return jax.random.normal(key, (self.nx,))

    def integrate(self, x, v):
        return x + v

    def difference(self, x0, x1):
        return x1 - x0

    def jintegrate(self, x, v, arg):
        return jnp.eye(self.ndx, dtype=jnp.result_type(x))

    def jdifference(self, x0, x1, arg):
        eye = jnp.eye(self.ndx, dtype=jnp.result_type(x0))
        return -eye if arg == 0 else eye

    def __eq__(self, other):
        return type(other) is VectorSpace and other.nx == self.nx

    def __hash__(self):
        return hash(("VectorSpace", self.nx))


class CartesianProduct(Manifold):
    """Product of manifolds (reference
    ``modelling/spaces/cartesian-product.hpp:13``)."""

    def __init__(self, *components: Manifold):
        flat = []
        for c in components:
            if isinstance(c, CartesianProduct):
                flat.extend(c.components)
            else:
                flat.append(c)
        self.components = tuple(flat)
        self.nx = sum(c.nx for c in self.components)
        self.ndx = sum(c.ndx for c in self.components)

    def _split_x(self, x):
        out, i = [], 0
        for c in self.components:
            out.append(x[..., i : i + c.nx])
            i += c.nx
        return out

    def _split_v(self, v):
        out, i = [], 0
        for c in self.components:
            out.append(v[..., i : i + c.ndx])
            i += c.ndx
        return out

    def neutral(self):
        return jnp.concatenate([c.neutral() for c in self.components], -1)

    def rand(self, key):
        keys = jax.random.split(key, len(self.components))
        return jnp.concatenate(
            [c.rand(k) for c, k in zip(self.components, keys)], -1
        )

    def integrate(self, x, v):
        return jnp.concatenate(
            [
                c.integrate(xc, vc)
                for c, xc, vc in zip(
                    self.components, self._split_x(x), self._split_v(v)
                )
            ],
            -1,
        )

    def difference(self, x0, x1):
        return jnp.concatenate(
            [
                c.difference(a, b)
                for c, a, b in zip(
                    self.components, self._split_x(x0), self._split_x(x1)
                )
            ],
            -1,
        )

    def jintegrate(self, x, v, arg):
        blocks = [
            c.jintegrate(xc, vc, arg)
            for c, xc, vc in zip(self.components, self._split_x(x), self._split_v(v))
        ]
        return jax.scipy.linalg.block_diag(*blocks)

    def jdifference(self, x0, x1, arg):
        blocks = [
            c.jdifference(a, b, arg)
            for c, a, b in zip(self.components, self._split_x(x0), self._split_x(x1))
        ]
        return jax.scipy.linalg.block_diag(*blocks)

    def is_normalized(self, x):
        flags = [
            c.is_normalized(xc) for c, xc in zip(self.components, self._split_x(x))
        ]
        out = flags[0]
        for f in flags[1:]:
            out = jnp.logical_and(out, f)
        return out

    def __mul__(self, other: Manifold):
        return CartesianProduct(self, other)

    def __eq__(self, other):
        return (
            type(other) is CartesianProduct and other.components == self.components
        )

    def __hash__(self):
        return hash(("CartesianProduct", self.components))


class TangentBundle(Manifold):
    """Phase space (q, v) over a base manifold (reference
    ``modelling/spaces/tangent-bundle.hpp:9``): configuration on ``base``,
    velocity in its tangent (Euclidean)."""

    def __init__(self, base: Manifold):
        self.base = base
        self.nx = base.nx + base.ndx
        self.ndx = 2 * base.ndx

    def neutral(self):
        return jnp.concatenate([self.base.neutral(), jnp.zeros(self.base.ndx)])

    def rand(self, key):
        k1, k2 = jax.random.split(key)
        return jnp.concatenate(
            [self.base.rand(k1), jax.random.normal(k2, (self.base.ndx,))]
        )

    def integrate(self, x, v):
        nq, nv = self.base.nx, self.base.ndx
        q = self.base.integrate(x[..., :nq], v[..., :nv])
        vel = x[..., nq:] + v[..., nv:]
        return jnp.concatenate([q, vel], -1)

    def difference(self, x0, x1):
        nq, nv = self.base.nx, self.base.ndx
        dq = self.base.difference(x0[..., :nq], x1[..., :nq])
        dv = x1[..., nq:] - x0[..., nq:]
        return jnp.concatenate([dq, dv], -1)

    def is_normalized(self, x):
        return self.base.is_normalized(x[..., : self.base.nx])

    def __eq__(self, other):
        return type(other) is TangentBundle and other.base == self.base

    def __hash__(self):
        return hash(("TangentBundle", self.base))
