"""Matmul-precision policy.

A float32 matmul on the accelerator may run at reduced precision unless
asked otherwise: on an H100, ``high`` (and the default) run f32 dots at TF32
accuracy, about 3e-4 relative error on a 512×512 product against 1e-6 for
``highest``. Two tiers are used here:

* ``high`` — problem evaluation, rollouts, multiplier updates.
* ``highest`` (full fp32) — the gar numeric core (Riccati recursions,
  condensed/parallel solves, contact KKTs): the μ-scaled KKT blocks have
  condition numbers near 1/μ, so reduced-precision rounding can destroy
  their positive definiteness and turn solves non-finite.

The package sets the global default to ``high`` (see ``__init__``);
functions in the numeric core pin ``highest`` via :func:`highest_precision`.
The fused Triton kernel is unaffected either way (scalar fp32 arithmetic,
no dots). Whether ``high`` still pays on the GPU is open: at humanoid dims
(nx=36) the TF32 residuals keep the dual infeasibility above tol=1e-3, so
no solve of that fleet converges under ``high``, while all do under a global
``highest`` (PERF.md).
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace ``fn`` with full-fp32 matmul passes regardless of the global
    default (the ops record the precision at trace time)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
