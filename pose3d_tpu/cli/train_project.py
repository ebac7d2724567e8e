"""Projector trainer: learned 3D->2D camera projection (phase-5 side model).

Mirrors phase5_loop/train_project.py:33-158: trains a ViT projector
(``MyViT(chw=(1,17,3), out_d=2)``, train_project.py API) on GT (3D, 2D)
pairs with L1 loss over the full-action data. The resulting checkpoint is
what ``train_loop --project 1 --projector_checkpoint <run>`` freezes.

Usage:
  python -m pose3d_tpu.cli.train_project --run_name proj1 --n_epochs 30
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu.config import LiftConfig, parse_config
from pose3d_tpu.cli.train_lift import load_split
from pose3d_tpu.models.lifters import JointTransformerLifter
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.epoch import (
    make_lifter_epoch_fn,
    make_lifter_eval_epoch_fn,
    stack_batches,
)
from pose3d_tpu.train.logging import MetricLogger
from pose3d_tpu.train.schedule import plateau_update
from pose3d_tpu.train.state import create_train_state


def train(cfg: LiftConfig):
    model = JointTransformerLifter(in_dim=3, out_dim=2)
    train_ds = load_split(cfg, is_train=True)
    test_ds = load_split(cfg, is_train=False)

    state = create_train_state(
        model, jax.random.key(cfg.seed), jnp.zeros((cfg.batch_size, 17, 3)),
        # bare Adam(lr), no decay — the reference projector trainer uses
        # Adam, not AdamW (train_project.py:42)
        lr=cfg.lr, optimizer="adam",
    )
    epoch_fn = make_lifter_epoch_fn(cfg.loss)
    eval_fn = make_lifter_eval_epoch_fn(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": "projector",
        "epochs": cfg.n_epochs,
    })

    rng = np.random.default_rng(cfg.seed)
    # projector direction: inputs are 3D poses, targets 2D keypoints
    vy1, vy2 = stack_batches((test_ds.kp3d, test_ds.kp2d), cfg.batch_size)
    vy1, vy2 = jnp.asarray(vy1), jnp.asarray(vy2)
    n_train = (len(train_ds) // cfg.batch_size) * cfg.batch_size
    n_val = vy1.shape[0] * cfg.batch_size

    for epoch in range(cfg.n_epochs):
        y1, y2 = stack_batches((train_ds.kp3d, train_ds.kp2d),
                               cfg.batch_size, rng)
        state, m = epoch_fn(state, jnp.asarray(y1), jnp.asarray(y2),
                            jax.random.key(cfg.seed * 31 + epoch))
        state = state.replace(
            plateau=plateau_update(state.plateau, m["last_batch_loss"]))
        vm = eval_fn(state, vy1, vy2)
        # 2D "MPJPE" here is the mean pixel-space L2 (x1000 = millipixels)
        logger.log_epoch(
            epoch, cfg.n_epochs, float(m["loss"]),
            float(jnp.mean(m["mpjpe_sums"][1:]) / n_train * 1000),
            float(vm["loss"]),
            float(jnp.mean(vm["mpjpe_sums"][1:]) / n_val * 1000),
            lr=float(state.plateau.lr),
        )

    path = ckpt.save(state, cfg.log_dir, cfg.run_name,
                     batch_size=cfg.batch_size)
    logger.finish()
    print(f"saved {path}")
    return state


if __name__ == "__main__":
    cfg = parse_config(LiftConfig)
    if cfg.run_name == "lift_run":
        cfg = dataclasses.replace(cfg, run_name="project_run")
    train(cfg)
