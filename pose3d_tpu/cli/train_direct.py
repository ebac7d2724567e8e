"""Phase-3/4 equivalent trainer: direct image -> 3D joint regression.

Mirrors phase3_direct/my_HybrIK/train_3.py (ResNet50 + deconv + 64^3
soft-argmax, MSE + Adam(wd 1e-8) + plateau, S1 train / S11 test with
split-rate subsampling and an action filter, de-standardized MPJPE in mm,
``infer()`` eval-only path) and phase4_joined/train.py (same model with
z_scale 2.0, trained on video frames with MotionBERT pseudo-GT via
``Custom_video_dataset``) — selected by ``--source h36m|video``.

Design: frames stream through the double-buffered device feed; the
Gaussian heatmap targets (when ``--heatmap_loss_weight`` > 0) are built on
device inside the jitted step; metrics stay on device until the epoch ends.

Usage:
  python -m pose3d_tpu.cli.train_direct --run_name d1 --n_epochs 5
  python -m pose3d_tpu.cli.train_direct --source video --video clip.mp4 \
      --pipeline_root ./videos
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu import losses
from pose3d_tpu.config import DirectConfig, parse_config
from pose3d_tpu.data import h36m, synthetic
from pose3d_tpu.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu.models.heads import PoseNet3D
from pose3d_tpu.parallel.mesh import make_mesh, replicated
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.image_steps import (
    make_direct_chunk_step,
    make_direct_eval_chunk_step,
    make_direct_eval_step,
)
from pose3d_tpu.train.logging import MetricLogger
from pose3d_tpu.train.schedule import plateau_update
from pose3d_tpu.train.state import create_train_state


def load_image_split(cfg: DirectConfig, is_train: bool):
    """-> (frames (N,256,256,3), kp3d (N,17,3), stats3d or None)."""
    d = cfg.data
    stats_dir = pathlib.Path(cfg.log_dir) / "run_time_utils"
    if getattr(cfg, "source", "h36m") == "video":
        from pose3d_tpu.data.video_dataset import load_video_dataset

        _, poses, frames = load_video_dataset(cfg.pipeline_root, cfg.video)
        split = int(len(poses) * 0.9)
        sl = slice(0, split) if is_train else slice(split, None)
        return frames[sl], poses[sl], None
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        subjects = ("S1",) if is_train else ("S11",)  # train_3.py:41-42
        kp2d, kp3d, paths, cams = h36m.read_data(
            d.data_dir, subjects, d.action, d.mono_3d_file, d.camera_view,
            load_frame_paths=True,
        )
        ds = h36m.preprocess(
            kp2d, kp3d, stats_dir, is_train=is_train, zero_centre=d.zero_centre,
            standardize_3d=d.standardize_3d, num_joints=d.num_joints,
            split_rate=d.split_rate, frame_paths=paths, cam_ids=cams,
        )
        from pose3d_tpu.data.native_loader import NativeImageLoader

        loader = NativeImageLoader(cfg.image_size)
        # uint8 to the device; normalization happens inside the jitted step
        frames = loader.decode_batch(ds.frame_paths, dtype=np.uint8)
        return frames, ds.kp3d, ds.stats3d
    # synthetic fallback: random frames + matching synthetic poses
    n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, 8)
    _, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
    kp3d = kp3d - kp3d[:, :1]
    frames = synthetic.synthetic_frames(n, cfg.image_size,
                                        seed=2 if is_train else 3)
    frames = (frames * 256.0).astype(np.uint8)
    return frames, kp3d, None


def _weight_decay(cfg: DirectConfig) -> float:
    """cfg.weight_decay=None -> the reference phase's optimizer default:
    phase 3 uses Adam(weight_decay=1e-8) (train_3.py:31), phase 4 a bare
    Adam(lr) with no decay (phase4_joined/train.py:39)."""
    if cfg.weight_decay is not None:
        return cfg.weight_decay
    return 0.0 if getattr(cfg, "source", "h36m") == "video" else 1e-8


def train(cfg: DirectConfig):
    dtype = jnp.bfloat16 if cfg.bf16 else jnp.float32
    # materialize the (B,17,64^3) heatmap volume only when it is supervised;
    # otherwise the head decodes straight from NHWC (no layout transpose)
    model = PoseNet3D(architecture=cfg.architecture, z_scale=cfg.z_scale,
                      return_heatmap=cfg.heatmap_loss_weight > 0,
                      dtype=dtype)
    frames, kp3d, stats3d = load_image_split(cfg, is_train=True)
    vframes, vkp3d, _ = load_image_split(cfg, is_train=False)

    mesh = make_mesh()
    state = create_train_state(
        model, jax.random.key(cfg.seed), jnp.zeros((2, cfg.image_size, cfg.image_size, 3)),
        lr=cfg.lr, optimizer=cfg.optimizer, weight_decay=_weight_decay(cfg),
    )
    state = jax.device_put(state, replicated(mesh))
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {int(state.step)}")

    k = max(cfg.chunk_steps, 1)
    step = make_direct_chunk_step(cfg.loss, cfg.heatmap_loss_weight)
    eval_step = make_direct_eval_chunk_step(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.architecture,
        "dataset": "H3.6", "epochs": cfg.n_epochs,
    })

    chunk_frames = k * cfg.batch_size
    n_train = (len(frames) // chunk_frames) * chunk_frames
    assert n_train > 0, (
        f"need >= {chunk_frames} frames (chunk_steps x batch_size); "
        f"got {len(frames)} — lower --chunk_steps or --batch_size"
    )
    # stage the stacked validation set on device once
    from pose3d_tpu.train.epoch import stack_batches

    vb = min(cfg.batch_size, len(vframes))
    vf_stack, vy_stack = stack_batches((vframes, vkp3d), vb)
    vf_stack, vy_stack = jnp.asarray(vf_stack), jnp.asarray(vy_stack)

    try:
        for epoch in range(cfg.n_epochs):
            # chunks of K batches: one dispatch drives K optimizer steps
            it = prefetch_to_device(
                batch_iterator((frames, kp3d), chunk_frames, shuffle=True,
                               seed=cfg.seed + epoch, epochs=1), mesh,
            )
            loss_acc, mpjpe_acc, last_loss = [], [], None
            for i, (f, y) in enumerate(it):
                f = f.reshape(k, cfg.batch_size, *f.shape[1:])
                y = y.reshape(k, cfg.batch_size, *y.shape[1:])
                state, m = step(state, f, y,
                                jax.random.key(epoch * 100003 + i))
                loss_acc.append(m["loss"])
                mpjpe_acc.append(m["mpjpe_sums"])
                last_loss = m["last_batch_loss"]
            state = state.replace(
                plateau=plateau_update(state.plateau, last_loss))

            # whole validation set in one dispatch
            vm = eval_step(state, vf_stack, vy_stack)
            n_val = vf_stack.shape[0] * vf_stack.shape[1]

            destd = (float(np.mean(stats3d.std))
                     if stats3d is not None and cfg.data.standardize_3d
                     else 1.0)
            # one host sync for all epoch metrics
            packed = np.asarray(jnp.stack([
                jnp.mean(jnp.stack(loss_acc)),
                losses.mpjpe_mm(
                    jnp.sum(jnp.stack(mpjpe_acc), 0) * destd, n_train),
                vm["loss"],
                losses.mpjpe_mm(vm["mpjpe_sums"] * destd, n_val),
                state.plateau.lr,
            ]))
            logger.log_epoch(
                epoch, cfg.n_epochs, float(packed[0]), float(packed[1]),
                float(packed[2]), float(packed[3]), lr=float(packed[4]),
            )
    except KeyboardInterrupt:
        path = ckpt.save(state, cfg.log_dir, "interrupt_" + cfg.run_name,
                         batch_size=cfg.batch_size)
        print(f"interrupted; saved {path}")
        raise

    path = ckpt.save(state, cfg.log_dir, cfg.run_name,
                     batch_size=cfg.batch_size)
    logger.finish()
    print(f"saved {path}")
    return state


def infer(cfg: DirectConfig):
    """Eval-only path (train_3.py:173-232 ``infer``): restore + validate."""
    dtype = jnp.bfloat16 if cfg.bf16 else jnp.float32
    model = PoseNet3D(architecture=cfg.architecture, z_scale=cfg.z_scale,
                      dtype=dtype)
    vframes, vkp3d, stats3d = load_image_split(cfg, is_train=False)
    mesh = make_mesh()
    state = create_train_state(
        model, jax.random.key(0),
        jnp.zeros((2, cfg.image_size, cfg.image_size, 3)), lr=cfg.lr,
        optimizer=cfg.optimizer, weight_decay=_weight_decay(cfg),
    )
    state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
    eval_step = make_direct_eval_step(cfg.loss)
    it = prefetch_to_device(
        batch_iterator((vframes, vkp3d), cfg.batch_size, shuffle=False,
                       epochs=1), mesh,
    )
    sums, n = None, 0
    for f, y in it:
        m = eval_step(state, f, y)
        sums = m["mpjpe_sums"] if sums is None else sums + m["mpjpe_sums"]
        n += f.shape[0]
    mpjpe = float(losses.mpjpe_mm(sums, n))
    print(f"infer MPJPE(val): {mpjpe:.2f} mm over {n} frames")
    return mpjpe


if __name__ == "__main__":
    import sys

    if "--infer" in sys.argv:
        sys.argv.remove("--infer")
        infer(parse_config(DirectConfig))
    else:
        train(parse_config(DirectConfig))
