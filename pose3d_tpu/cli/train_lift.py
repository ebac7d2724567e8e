"""Phase-1 equivalent trainer: 2D->3D lifting on Human3.6M keypoints.

Mirrors phase1_lifting/train_1.py's behavior — model zoo selection
(MyViT default, train_1.py:35), MSE loss + AdamW (:37-39), plateau LR
(:41), subjects S1..S8 train / S9,S11 test with an action filter (:48-49),
per-epoch MPJPE in mm with the (17/16)x1000 convention (:102-104),
flip-TTA validation (Flip flag), checkpoint + resume (:43-46, :186) —
re-architected for an accelerator: whole epochs run as single jitted lax.scan programs
(see pose3d_tpu.train.epoch), data lives in device memory for the whole run, and the
host only syncs once per epoch for logging.

Usage:
  python -m pose3d_tpu.cli.train_lift --run_name my_run --n_epochs 50
  python -m pose3d_tpu.cli.train_lift --data.data_dir /data/h3.6  # real npz
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu import losses
from pose3d_tpu.config import LiftConfig, parse_config
from pose3d_tpu.data import h36m, synthetic
from pose3d_tpu.models.lifters import (
    AELifter,
    JointTransformerLifter,
    MartinezLifter,
)
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.epoch import (
    make_lifter_epoch_fn,
    make_lifter_eval_epoch_fn,
    stack_batches,
)
from pose3d_tpu.train.logging import MetricLogger
from pose3d_tpu.train.schedule import plateau_update
from pose3d_tpu.train.state import create_train_state


def build_lifter(name: str, num_joints: int = 17):
    if name == "vit":
        return JointTransformerLifter(n_joints=num_joints)
    if name == "martinez":
        return MartinezLifter(in_dim=num_joints * 2, out_dim=num_joints * 3)
    if name == "ae":
        return AELifter(in_dim=num_joints * 2, out_dim=num_joints * 3)
    raise ValueError(name)


def load_split(cfg: LiftConfig, is_train: bool):
    d = cfg.data
    stats_dir = pathlib.Path(cfg.log_dir) / "run_time_utils"
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        subjects = d.train_subjects if is_train else d.test_subjects
        kp2d, kp3d, paths, cams = h36m.read_data(
            d.data_dir, subjects, d.action, d.mono_3d_file, d.camera_view,
            d.all_cameras,
        )
    else:  # hermetic synthetic fallback (no H36M export in this environment)
        n = d.synthetic_frames if is_train else d.synthetic_frames // 4
        kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
        paths = cams = None
    ds = h36m.preprocess(
        kp2d, kp3d, stats_dir, is_train=is_train, zero_centre=d.zero_centre,
        standardize_2d=d.standardize_2d, standardize_3d=d.standardize_3d,
        normalize=d.normalize, num_joints=d.num_joints,
        split_rate=d.split_rate, frame_paths=paths, cam_ids=cams,
    )
    return ds


def train(cfg: LiftConfig):
    d = cfg.data
    model = build_lifter(cfg.model, d.num_joints)
    train_ds = load_split(cfg, is_train=True)
    test_ds = load_split(cfg, is_train=False)

    state = create_train_state(
        model, jax.random.key(cfg.seed),
        jnp.zeros((cfg.batch_size, d.num_joints, 2)), lr=cfg.lr,
        grad_clip=cfg.grad_clip,
    )
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, meta = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {int(state.step)}")

    epoch_fn = make_lifter_epoch_fn(cfg.loss)
    eval_fn = make_lifter_eval_epoch_fn(cfg.loss, flip_tta=cfg.flip)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.model,
        "dataset": "H3.6" if d.data_dir else "synthetic",
        "epochs": cfg.n_epochs,
    })

    rng = np.random.default_rng(cfg.seed)
    # eval batches are fixed (no shuffle, reference test_loader shuffle=False)
    vy1, vy2 = stack_batches((test_ds.kp2d, test_ds.kp3d), cfg.batch_size)
    vy1, vy2 = jnp.asarray(vy1), jnp.asarray(vy2)
    n_train = (len(train_ds) // cfg.batch_size) * cfg.batch_size
    n_val = vy1.shape[0] * cfg.batch_size

    try:
        for epoch in range(cfg.n_epochs):
            y1, y2 = stack_batches(
                (train_ds.kp2d, train_ds.kp3d), cfg.batch_size, rng
            )
            state, m = epoch_fn(
                state, jnp.asarray(y1), jnp.asarray(y2),
                jax.random.key(cfg.seed * 100003 + epoch),
            )
            # reference: scheduler steps on the LAST batch's train loss
            # (train_1.py:106)
            state = state.replace(
                plateau=plateau_update(state.plateau, m["last_batch_loss"])
            )
            vm = eval_fn(state, vy1, vy2)
            train_mpjpe = float(losses.mpjpe_mm(
                m["mpjpe_sums"], n_train, d.num_joints, d.zero_centre))
            val_mpjpe = float(losses.mpjpe_mm(
                vm["mpjpe_sums"], n_val, d.num_joints, d.zero_centre))
            logger.log_epoch(
                epoch, cfg.n_epochs, float(m["loss"]), train_mpjpe,
                float(vm["loss"]), val_mpjpe, lr=float(state.plateau.lr),
            )
    except KeyboardInterrupt:
        if cfg.ctlc_save:
            path = ckpt.save(state, cfg.log_dir, "interrupt_" + cfg.run_name,
                             batch_size=cfg.batch_size)
            print(f"interrupted; saved {path}")
        raise

    path = ckpt.save(state, cfg.log_dir, cfg.run_name,
                     batch_size=cfg.batch_size, extra={"model": cfg.model})
    _save_visualizations(cfg, state, vy1, vy2)
    logger.finish()
    print(f"saved {path}")
    return state


def _save_visualizations(cfg: LiftConfig, state, vy1, vy2):
    """End-of-run GT-vs-pred renders (train_1.py:159-184 convention:
    first/last validation samples into logs/visualizations/<run>/)."""
    try:
        from pose3d_tpu.train.steps import _apply
        from pose3d_tpu.utils.visualize import visualize_3d

        pred, _ = _apply(state, state.params, vy1[0], train=False)
        pred = np.asarray(pred).reshape(-1, vy2.shape[-2], 3)
        gt = np.asarray(vy2[0])
        out_dir = pathlib.Path(cfg.log_dir) / "visualizations" / cfg.run_name
        visualize_3d(gt[0], pred[0], out_dir / "3d_test_a.png")
        visualize_3d(gt[-1], pred[-1], out_dir / "3d_test_b.png")
    except Exception as e:  # rendering must never kill a training run
        print(f"visualization skipped: {e}")


if __name__ == "__main__":
    train(parse_config(LiftConfig))
