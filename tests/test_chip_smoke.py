"""chip_smoke.py's helpers on the CPU: the device gate, the compile-cache
path, the form of the last line, and the four-card comparison logic on four
virtual CPU devices (conftest provides eight)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import pytest

import chip_smoke
from aligator_tpu.utils import device as device_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fake(platform, kind="k"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        device_mod.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        device_mod.require_gpu([])
    gpus = [_fake("gpu", "NVIDIA H100 80GB HBM3")]
    assert device_mod.require_gpu(gpus) is gpus


@pytest.mark.parametrize(
    "environ,expected",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
        ({}, str(ROOT / ".jax_cache")),
        ({"JAX_COMPILATION_CACHE_DIR": ""}, str(ROOT / ".jax_cache")),
    ],
)
def test_compile_cache_dir(environ, expected):
    assert device_mod.compile_cache_dir(environ, ROOT) == expected


def test_enable_compile_cache_follows_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert device_mod.enable_compile_cache(ROOT) == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", before)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert device_mod.enable_compile_cache(ROOT) == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_last_line_form():
    devs = [_fake("gpu", "NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.last_line(devs[:1])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert json.loads(chip_smoke.last_line(devs))["device"]["count"] == 4


@pytest.mark.parametrize(
    "text,expected",
    [
        ('custom-call(%a), custom_call_target="__gpu$xla.gpu.triton"', True),
        ("%fusion = f32[8] fusion(%p), kind=kLoop", False),
        ('fusion(%p), kind=kCustom, backend_config={"kind":"__triton_gemm"}',
         False),
    ],
)
def test_has_triton_call(text, expected):
    assert chip_smoke.has_triton_call(text) is expected


def test_rel_diff_and_nonfinite_fraction():
    import numpy as np

    assert chip_smoke.rel_diff([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert chip_smoke.rel_diff([1.0, 2.5], [1.0, 2.0]) == pytest.approx(0.25)
    assert chip_smoke.rel_diff(np.zeros((3, 0)), np.zeros((3, 0))) == 0.0
    us = np.ones((4, 2, 2))
    us[1, 0, 1] = np.nan
    assert chip_smoke.nonfinite_fraction(us) == 0.25


def test_to_float64_keeps_problem_data():
    import jax.numpy as jnp

    import bench

    p32 = bench.se2_problem(nsteps=3)
    with jax.enable_x64(True):
        p64 = chip_smoke.to_float64(p32)
        for a, b in zip(jax.tree.leaves(p32), jax.tree.leaves(p64)):
            if jnp.issubdtype(a.dtype, jnp.floating):
                assert b.dtype == jnp.float64
                assert bool(jnp.all(b.astype(a.dtype) == a))


def test_four_card_fleet_logic():
    rec = chip_smoke.phase_four_card_fleet(jax.devices()[:4], batch=8,
                                           nsteps=5)
    assert rec["vs_one_device"] <= chip_smoke.TOL_FOUR_CARD_BATCH
    assert len({s["device"] for s in rec["shards"]}) == 4
    assert rec["nonfinite_frac"] == 0.0


def test_four_card_legs_logic():
    rec = chip_smoke.phase_four_card_legs(jax.devices()[:4], N=63)
    assert rec["legs"] == 4
    assert len({s["device"] for s in rec["shards"]}) == 4
    assert max(rec["vs_serial"].values()) <= chip_smoke.TOL_FOUR_CARD_LEGS


def _run_script(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_exits_without_gpu():
    r = _run_script(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_lq_kernel_phase_interpret():
    """Phase 2's comparison logic with the kernel in the interpreter."""
    (rec,) = chip_smoke.phase_lq_kernel([(4, 3, 2, 1, False)], batch=32,
                                        f64_sample=8, interpret=True)
    assert rec["triton_in_hlo"] is False
    assert max(rec["kernel_vs_scan"].values()) <= chip_smoke.TOL_KERNEL_VS_SCAN
    assert len(rec["kkt_kernel"]) == 3
