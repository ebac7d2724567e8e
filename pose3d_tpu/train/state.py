"""Train state pytree: params + batch stats + optimizer + plateau schedule.

Replaces the reference's ad-hoc ``torch.save({'epoch', 'batch_size', 'model',
'optimizer'})`` checkpoints (train_1.py:186 etc.) with a single jit-friendly
pytree. The learning rate lives in ``plateau.lr`` and is injected into the
optax update every step (optax.inject_hyperparams), so the plateau schedule
runs entirely on device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from pose3d_tpu.train.schedule import PlateauState, plateau_init


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any
    plateau: PlateauState
    tx: optax.GradientTransformation = dataclasses.field(
        metadata={"static": True})
    apply_fn: Callable = dataclasses.field(metadata={"static": True})

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def variables(self):
        v = {"params": self.params}
        if self.batch_stats:
            v["batch_stats"] = self.batch_stats
        return v

    def apply_gradients(self, grads, new_batch_stats=None):
        updates, new_opt_state = self.tx.update(grads, self.opt_state, self.params)
        params = optax.apply_updates(self.params, updates)
        return self.replace(
            step=self.step + 1,
            params=params,
            opt_state=new_opt_state,
            batch_stats=(
                new_batch_stats if new_batch_stats is not None else self.batch_stats
            ),
        )

    def with_lr(self, lr):
        """Write the plateau lr into the injected optimizer hyperparams.

        The stored rate is computed (a learning rate is never negative),
        not the plateau's own value: a donated train step that returns one
        input buffer as two outputs had the GPU runtime free that buffer
        twice and abort the process (JAX 0.9, H100)."""
        hp = dict(self.opt_state.hyperparams)
        hp["learning_rate"] = jnp.maximum(jnp.asarray(lr, jnp.float32), 0.0)
        return self.replace(opt_state=self.opt_state._replace(hyperparams=hp))


def make_optimizer(
    lr: float, kind: str = "adamw", weight_decay: float | None = None,
    grad_clip: float = 0.0,
) -> optax.GradientTransformation:
    """AdamW (train_1.py:39) or Adam with the reference's tiny weight decay
    (train_3.py uses Adam(weight_decay=1e-8)); optional global-norm gradient
    clipping (the legacy main.py:467-468 clip flag).

    ``weight_decay=None`` resolves to the torch default for the kind: the
    reference constructs bare ``torch.optim.AdamW(lr=lr)`` (train_1.py:39),
    whose default decoupled weight decay is 1e-2 — NOT optax.adamw's 1e-4 —
    and ``torch.optim.Adam`` defaults to 0. Adam's weight decay is the
    torch-coupled form (wd*p added to the gradient before the moment
    updates), matching Adam(weight_decay=...) semantics exactly; AdamW's is
    decoupled, matching torch AdamW. Both proven by one-step transplant
    parity in tests/test_reference_parity_train.py.
    """
    if kind not in ("adamw", "adam", "sgd"):
        raise ValueError(kind)
    if weight_decay is None:
        weight_decay = 1e-2 if kind == "adamw" else 0.0

    def build(learning_rate):
        chain = []
        if grad_clip:
            chain.append(optax.clip_by_global_norm(grad_clip))
        if kind == "adamw":
            chain.append(optax.adamw(learning_rate,
                                     weight_decay=weight_decay))
        elif kind == "sgd":
            # plain SGD (no reference trainer uses it; kept for ablations
            # and for exact linear-in-gradients equivalence tests — Adam's
            # first step is elementwise sign descent, which amplifies f32
            # reduction-order noise on near-zero gradients to +-lr)
            if weight_decay:
                chain.append(optax.add_decayed_weights(weight_decay))
            chain.append(optax.sgd(learning_rate))
        else:
            if weight_decay:
                chain.append(optax.add_decayed_weights(weight_decay))
            chain.append(optax.adam(learning_rate))
        return optax.chain(*chain) if len(chain) > 1 else chain[0]

    return optax.inject_hyperparams(build)(learning_rate=lr)


def create_train_state(
    model, rng, example_input, lr: float, optimizer: str = "adamw",
    weight_decay: float | None = None, grad_clip: float = 0.0,
    train_kwargs=None,
) -> TrainState:
    # one jitted init instead of one dispatch per op (seconds for a ResNet)
    import functools

    init_fn = jax.jit(
        functools.partial(model.init, train=True, **(train_kwargs or {}))
    )
    variables = init_fn(
        {"params": rng, "dropout": jax.random.fold_in(rng, 1)},
        example_input,
    )
    tx = make_optimizer(lr, optimizer, weight_decay, grad_clip)
    params = variables["params"]
    return TrainState(
        step=jnp.asarray(0, jnp.int32),
        params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(params),
        plateau=plateau_init(lr),
        tx=tx,
        apply_fn=model.apply,
    )
