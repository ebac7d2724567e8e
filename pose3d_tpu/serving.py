"""Serving: bucketed, precompiled lifting inference.

Production-path counterpart to the training CLIs (the reference has no
serving story at all — inference is a by-product of its train loops):

- fixed batch-size buckets (powers of two up to ``max_batch``) so every
  request shape hits a precompiled executable — no retrace, no dynamic
  shapes;
- requests are padded up to the bucket and the padding sliced off after;
- the model's own ``apply`` runs in its compute dtype (bfloat16 for
  throughput), outputs float32;
- optional multi-device serving: pass ``mesh=`` to shard each bucket's
  batch over the mesh's data axis via ``shard_map`` (each device runs the
  same single-device program on its shard; no cross-device communication
  exists in a lifter forward).
"""

from __future__ import annotations

import numpy as np


class LifterService:
    """Wraps a trained lifter for padded, bucketed batch inference."""

    def __init__(self, model, params, batch_stats=None, *,
                 max_batch: int = 8192, min_bucket: int = 64, mesh=None):
        import jax
        import jax.numpy as jnp

        self._jnp = jnp
        self.model = model
        self.params = params
        self.batch_stats = batch_stats or {}
        self.mesh = mesh
        if mesh is not None:
            from pose3d_tpu.parallel.mesh import DATA_AXIS

            n_shards = mesh.shape[DATA_AXIS]
            # every bucket must split evenly over the data axis
            min_bucket = max(min_bucket, n_shards)
            if min_bucket % n_shards:
                min_bucket = ((min_bucket // n_shards) + 1) * n_shards
        self.buckets = []
        b = min_bucket
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2

        variables = {"params": params}
        if self.batch_stats:
            variables["batch_stats"] = self.batch_stats

        def base(kp2d):
            return model.apply(variables, kp2d, train=False)

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from pose3d_tpu.parallel.mesh import DATA_AXIS

            base = jax.shard_map(base, mesh=mesh, in_specs=P(DATA_AXIS),
                                 out_specs=P(DATA_AXIS))

        self._fn = jax.jit(base)

    def warmup(self):
        """Precompile every bucket (first request latency -> ~0)."""
        for b in self.buckets:
            self._fn(self._jnp.zeros((b, 17, 2))).block_until_ready()
        return self

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def lift(self, kp2d: np.ndarray) -> np.ndarray:
        """(N,17,2) -> (N,17,3); N arbitrary (chunked over the top bucket)."""
        jnp = self._jnp
        kp2d = np.asarray(kp2d, np.float32)
        n = len(kp2d)
        out = np.empty((n, 17, 3), np.float32)
        top = self.buckets[-1]
        pos = 0
        while pos < n:
            chunk = kp2d[pos: pos + top]
            b = self._bucket(len(chunk))
            if len(chunk) < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - len(chunk), 17, 2), np.float32)]
                )
            pred = np.asarray(self._fn(jnp.asarray(chunk))).reshape(b, 17, 3)
            take = min(top, n - pos)
            out[pos: pos + take] = pred[:take]
            pos += take
        return out
