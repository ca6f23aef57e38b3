"""Device checks and compile-cache setup for the GPU entry points.

``chip_smoke.py`` and ``bench.py`` measure the program on an NVIDIA GPU, so
they refuse any other device instead of falling back, name the device in
what they print, and keep JAX's persistent compile cache at one fixed path.
"""

from __future__ import annotations

import os
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ, repo_root) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return environ.get(CACHE_ENV) or os.path.join(
        os.path.abspath(repo_root), ".jax_cache"
    )


def enable_compile_cache(repo_root) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    When the environment variable is set JAX reads it itself and nothing is
    changed here."""
    import jax

    path = compile_cache_dir(os.environ, repo_root)
    if CACHE_ENV not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices):
    """Raise unless the first device is a GPU (no fallback to the CPU)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"needs an NVIDIA GPU; JAX found platform {found!r}")
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
