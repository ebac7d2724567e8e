"""Device mesh + sharding strategy.

The reference is single-process / single-GPU with no parallelism of any kind
(SURVEY.md section 2.7); this module is the replacement: a
``jax.sharding.Mesh`` over all local devices with named axes

- ``data``  — batch (data-parallel) axis; gradients all-reduce over NVLink
  via the psum XLA inserts for us under jit (NCCL on the GPU),
- ``model`` — tensor-parallel axis for the wide (1024x1024) Martinez layers
  and attention heads when scaling model size.

Everything goes through GSPMD: we annotate shardings (NamedSharding /
with_sharding_constraint) and let XLA insert collectives, per the standard
scaling-book recipe. No hand-written NCCL-style communication.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Defaults to all devices on the data axis — the right strategy for the
    pose models in this framework (small weights, large batches).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = devices.size // n_model
    assert n_data * n_model == devices.size, (
        f"mesh {n_data}x{n_model} != {devices.size} devices"
    )
    return Mesh(devices.reshape(n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis, replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Device-put a pytree of host arrays with batch-axis sharding."""
    s = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), batch)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
