"""Reduce-LR-on-plateau as a pure, jit-compatible state transition.

Reproduces torch.optim.lr_scheduler.ReduceLROnPlateau with the reference's
hyperparameters (train_1.py:41: factor=0.7, patience=3, cooldown=2,
min_lr=5e-6; mode='min', threshold=1e-4, threshold_mode='rel') as a tiny
pytree updated inside the jitted epoch step — no host round-trip.

torch semantics reproduced exactly:
- better  <=> metric < best * (1 - threshold)
- in cooldown: cooldown -= 1 and num_bad is pinned to 0
- when num_bad > patience: lr = max(lr * factor, min_lr), cooldown resets,
  num_bad resets.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PlateauState:
    lr: jnp.ndarray        # scalar f32
    best: jnp.ndarray      # scalar f32
    num_bad: jnp.ndarray   # scalar i32
    cooldown: jnp.ndarray  # scalar i32

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(
        lr=jnp.asarray(lr, jnp.float32),
        best=jnp.asarray(jnp.inf, jnp.float32),
        num_bad=jnp.asarray(0, jnp.int32),
        cooldown=jnp.asarray(0, jnp.int32),
    )


def plateau_update(
    state: PlateauState,
    metric,
    *,
    factor: float = 0.7,
    patience: int = 3,
    cooldown: int = 2,
    min_lr: float = 5e-6,
    threshold: float = 1e-4,
) -> PlateauState:
    """One scheduler step on a new (lower-is-better) metric value."""
    metric = jnp.asarray(metric, jnp.float32)
    is_better = metric < state.best * (1.0 - threshold)
    best = jnp.where(is_better, metric, state.best)
    num_bad = jnp.where(is_better, 0, state.num_bad + 1)

    in_cooldown = state.cooldown > 0
    cool = jnp.where(in_cooldown, state.cooldown - 1, state.cooldown)
    num_bad = jnp.where(in_cooldown, 0, num_bad)

    reduce_now = num_bad > patience
    lr = jnp.where(reduce_now, jnp.maximum(state.lr * factor, min_lr), state.lr)
    cool = jnp.where(reduce_now, cooldown, cool)
    num_bad = jnp.where(reduce_now, 0, num_bad)
    return PlateauState(lr=lr, best=best, num_bad=num_bad, cooldown=cool)
