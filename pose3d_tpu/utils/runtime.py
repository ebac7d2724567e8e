"""Process set-up shared by the on-device scripts (``bench.py``,
``chip_smoke.py``): the persistent compile cache and a description of the
accelerator the process runs on."""

from __future__ import annotations

import os
import pathlib
import subprocess

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
ENV_CACHE = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """Where compiled executables persist: ``$JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``<repo>/logs/jax_cache``. The
    path is part of the cache key, so it is fixed, not relative to the
    working directory."""
    return os.environ.get(ENV_CACHE) or str(REPO_ROOT / "logs" / "jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory. With
    ``JAX_COMPILATION_CACHE_DIR`` set nothing is configured in code."""
    if not os.environ.get(ENV_CACHE):
        import jax

        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return compile_cache_dir()


def nvidia_smi() -> str:
    """``name, power.limit`` of each card as nvidia-smi prints them, or
    the reason it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def device_info() -> dict:
    """Platform, kind and count of the devices JAX runs on."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
