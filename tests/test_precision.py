"""Matmul-precision policy guards (see aligator_tpu/_precision.py).

Reduced-precision f32 matmuls (TF32 on a GPU, bf16 passes elsewhere) can
destroy positive definiteness inside the μ-scaled recursion, so the gar
core pins 'highest' under a global 'high' default. These guard the
configuration; chip_smoke.py's non-finite and converged fractions guard
the numerics on the card."""

import jax
import jax.numpy as jnp


def test_global_default_is_high():
    import aligator_tpu  # noqa: F401

    assert jax.config.jax_default_matmul_precision == "high"


def test_gar_core_pins_highest():
    """The decorated numeric core must trace its matmuls with fp32 passes
    even under a lower global default."""
    from aligator_tpu._precision import highest_precision

    captured = {}

    @highest_precision
    def probe(a, b):
        captured["prec"] = jax.config.jax_default_matmul_precision
        return a @ b

    with jax.default_matmul_precision("bfloat16"):
        probe(jnp.eye(3), jnp.eye(3))
    assert captured["prec"] == "highest"

    from aligator_tpu.gar import riccati

    assert riccati.backward.__wrapped__ is not riccati.backward
