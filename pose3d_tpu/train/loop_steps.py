"""Multi-model consistency-loop training step (phase 5).

Reference contract (phase5_loop/train_5.py:52-338): four models — trained
``Model_2D`` + ``Model_3D`` (AdamW lr 5e-4 each, per-model plateau
schedulers), a FROZEN phase-1 ViT lifter (lr-0 optimizer in the reference,
train_5.py:81), an optional FROZEN ViT projector — combined through
``TriangleLoss_sep`` (losses.py:65-118) or plain per-model MSE, with
flip-consistency (horizontal image flip, all predictions re-estimated and
averaged through the flip, train_5.py:153-168).

Redesign:
- freezing is structural: frozen params are plain (non-optimizer) leaves of
  the step's state — no lr-0 optimizer needed (optax.set_to_zero semantics
  by construction);
- the flip-consistency pass batches {identity, flip} into one forward of
  2x batch instead of sequentially re-running every model (the reference
  runs up to 8 forwards per batch);
- both trained models' gradients come from ONE backward over the combined
  loss: their parameters are disjoint, so this is exactly the reference's
  "single backward through 2d+3d graphs" (train_5.py:170-181).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from pose3d_tpu import losses
from pose3d_tpu.core.transforms import flip_pose
from pose3d_tpu.train.schedule import plateau_update
from pose3d_tpu.train.state import TrainState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LoopState:
    net2d: TrainState
    net3d: TrainState
    lifter_params: Any = None
    projector_params: Any = None

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def make_loop_train_step(
    lifter_apply: Optional[Callable] = None,
    projector_apply: Optional[Callable] = None,
    *, triangle: bool = False, flip: bool = False, project: bool = False,
    triangle_mode: str = "sep", donate: bool = True,
    return_grads: bool = False,
):
    """(LoopState, frames, y1 (B,17,2), y2 (B,17,3), rng) ->
    (LoopState, metrics).

    ``triangle_mode``: "sep" -> supervised ``TriangleLoss_sep``
    (phase5_loop/losses.py:65-118, the committed train_5.py default);
    "cycle" -> unsupervised-coupling ``TriangleLoss`` (losses.py:10-62),
    whose lift term ties the two predictions together:
    L1(lift(pred2d), pred3d) (losses.py:30).
    """
    if triangle_mode not in ("sep", "cycle"):
        raise ValueError(f"triangle_mode must be sep|cycle, got {triangle_mode}")

    def forward_all(state: LoopState, p2d, p3d, frames, rng):
        """2D + 3D predictions, optionally flip-averaged in one 2x batch."""
        b = frames.shape[0]
        if flip:
            frames = jnp.concatenate([frames, frames[:, :, ::-1, :]], 0)
        v2d = {"params": p2d, "batch_stats": state.net2d.batch_stats}
        v3d = {"params": p3d, "batch_stats": state.net3d.batch_stats}
        y1_hat, bs2 = state.net2d.apply_fn(
            v2d, frames, train=True, rngs={"dropout": rng},
            mutable=["batch_stats"],
        )
        (y2_hat, _), bs3 = state.net3d.apply_fn(
            v3d, frames, train=True,
            rngs={"dropout": jax.random.fold_in(rng, 1)},
            mutable=["batch_stats"],
        )
        y1_hat = y1_hat.reshape(-1, 17, 2)
        y2_hat = y2_hat.reshape(-1, 17, 3)
        if flip:
            y1_hat = (y1_hat[:b] + flip_pose(y1_hat[b:])) / 2.0
            y2_hat = (y2_hat[:b] + flip_pose(y2_hat[b:])) / 2.0
        return y1_hat, y2_hat, bs2["batch_stats"], bs3["batch_stats"]

    def step(state: LoopState, frames, y1, y2, rng):
        def loss_fn(p2d, p3d):
            y1_hat, y2_hat, bs2, bs3 = forward_all(state, p2d, p3d, frames, rng)
            if triangle:
                assert lifter_apply is not None
                lift_pred = lifter_apply(
                    {"params": state.lifter_params}, y1_hat, train=False
                ).reshape(y2.shape)
                proj_pred = proj_gt = None
                if project and projector_apply is not None:
                    proj_pred = projector_apply(
                        {"params": state.projector_params}, y2_hat, train=False
                    ).reshape(y1.shape)
                if triangle_mode == "cycle":
                    total, terms = losses.triangle_loss(
                        y1_hat, y2_hat, lift_pred, y1, y2, proj_pred,
                    )
                else:
                    lift_gt = lifter_apply(
                        {"params": state.lifter_params}, y1, train=False
                    ).reshape(y2.shape)
                    if project and projector_apply is not None:
                        proj_gt = projector_apply(
                            {"params": state.projector_params}, y2,
                            train=False,
                        ).reshape(y1.shape)
                    total, terms = losses.triangle_loss_sep(
                        y1_hat, y2_hat, lift_gt, lift_pred, y1, y2,
                        proj_pred, proj_gt,
                    )
            else:
                terms = {
                    "loss_2d": losses.mse(y1_hat, y1),
                    "loss_3d": losses.mse(y2_hat, y2),
                }
                total = terms["loss_2d"] + terms["loss_3d"]
            aux = (terms, y2_hat, bs2, bs3)
            return total, aux

        (total, (terms, y2_hat, bs2, bs3)), (g2d, g3d) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(state.net2d.params, state.net3d.params)

        net2d = state.net2d.with_lr(state.net2d.plateau.lr)
        net3d = state.net3d.with_lr(state.net3d.plateau.lr)
        net2d = net2d.apply_gradients(g2d, bs2)
        net3d = net3d.apply_gradients(g3d, bs3)
        metrics = {
            "loss": total,
            "mpjpe_sums": losses.loss_mpjpe(y2_hat, y2),
            **terms,
        }
        if return_grads:  # mesh-oracle tests inspect the all-reduced grads
            metrics["g2d"], metrics["g3d"] = g2d, g3d
        return state.replace(net2d=net2d, net3d=net3d), metrics

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_loop_eval_step(flip: bool = False):
    def step(state: LoopState, frames, y1, y2):
        b = frames.shape[0]
        f = frames
        if flip:
            f = jnp.concatenate([frames, frames[:, :, ::-1, :]], 0)
        v2d = {"params": state.net2d.params,
               "batch_stats": state.net2d.batch_stats}
        v3d = {"params": state.net3d.params,
               "batch_stats": state.net3d.batch_stats}
        y1_hat = state.net2d.apply_fn(v2d, f, train=False).reshape(-1, 17, 2)
        y2_hat = state.net3d.apply_fn(v3d, f, train=False)[0].reshape(-1, 17, 3)
        if flip:
            y1_hat = (y1_hat[:b] + flip_pose(y1_hat[b:])) / 2.0
            y2_hat = (y2_hat[:b] + flip_pose(y2_hat[b:])) / 2.0
        return {
            "loss": losses.mse(y2_hat, y2),
            "loss_2d": losses.mse(y1_hat, y1),
            "mpjpe_sums": losses.loss_mpjpe(y2_hat, y2),
        }

    return jax.jit(step)


@jax.jit
def loop_plateau_step(state: LoopState, metric):
    """Per-model plateau schedulers (train_5.py:85-88)."""
    return state.replace(
        net2d=state.net2d.replace(
            plateau=plateau_update(state.net2d.plateau, metric)),
        net3d=state.net3d.replace(
            plateau=plateau_update(state.net3d.plateau, metric)),
    )
