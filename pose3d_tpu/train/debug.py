"""Observability and failure-detection hooks (SURVEY.md section 5).

The reference has no tracing/profiling/sanitizing at all (only tqdm bars and
wall-clock prints). The equivalents here:

- :func:`profile` — context manager wrapping ``jax.profiler`` trace capture
  (view with tensorboard / xprof). Enable per-run via ``POSE3D_PROFILE=dir``.
- :func:`nan_check_mode` — context manager enabling jax's debug-nans so the
  first non-finite value raises at the producing op instead of corrupting
  the run (replaces interactive breakpoint() debugging as methodology).
- :func:`assert_finite` — jittable guard (jax.debug-based) for inserting
  explicit checkpoints in custom training loops.
- :class:`StepTimer` — per-step wall-clock with proper device sync, for
  quick throughput numbers without a full profile.
"""

from __future__ import annotations

import contextlib
import os
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def profile(log_dir=None):
    """Capture a jax.profiler trace for the enclosed block."""
    log_dir = log_dir or os.environ.get("POSE3D_PROFILE")
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def nan_check_mode(enable: bool = True):
    """Raise on the first NaN produced anywhere under jit."""
    if not enable:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(x, name: str = "tensor"):
    """Jittable finite-check: debug-prints a warning on non-finite values."""
    ok = jnp.all(jnp.isfinite(x))
    jax.lax.cond(
        ok,
        lambda: None,
        lambda: jax.debug.print("WARNING: non-finite values in " + name),
    )
    return x


class StepTimer:
    """Throughput probe: sync once per window, report steps/s and items/s."""

    def __init__(self, window: int = 50):
        self.window = window
        self.count = 0
        self.items = 0
        self.t0 = None

    def tick(self, result, batch_size: int = 0):
        if self.t0 is None:
            jax.block_until_ready(result)
            self.t0 = time.perf_counter()
            self.count = 0
            self.items = 0
            return None
        self.count += 1
        self.items += batch_size
        if self.count % self.window == 0:
            jax.block_until_ready(result)
            dt = time.perf_counter() - self.t0
            stats = {
                "steps_per_s": self.count / dt,
                "items_per_s": self.items / dt if self.items else None,
            }
            return stats
        return None
