"""Phase-5 equivalent trainer: 2D + 3D + frozen lifter consistency loop.

Mirrors phase5_loop/train_5.py: Model_2D + Model_3D trained jointly (AdamW
5e-4, per-model plateau schedulers), a frozen phase-1 ViT lifter restored
from its checkpoint (train_5.py:68-69), an optional frozen ViT projector
(train_project checkpoint, :60-65), Triangle/Flip/Project toggles
(:342-374), Walking-subset data with split_rate 64 (:95-96).

Usage:
  python -m pose3d_tpu.cli.train_loop --triangle 1 --flip 1 \
      --lifter_checkpoint lift_run --run_name loop1
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu import losses
from pose3d_tpu.config import LoopConfig, parse_config
from pose3d_tpu.data import h36m, synthetic
from pose3d_tpu.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D
from pose3d_tpu.models.lifters import JointTransformerLifter
from pose3d_tpu.parallel.mesh import make_mesh, replicated
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.logging import MetricLogger
from pose3d_tpu.train.loop_steps import (
    LoopState,
    loop_plateau_step,
    make_loop_eval_step,
    make_loop_train_step,
)
from pose3d_tpu.train.state import create_train_state


def _load_frozen(model, example, log_dir, run_name):
    """Restore a frozen model's params from a phase-1-style checkpoint
    (params-only partial restore — independent of the optimizer layout the
    checkpoint was trained with)."""
    template = model.init({"params": jax.random.key(0)}, example,
                          train=False)["params"]
    if run_name and ckpt.exists(log_dir, run_name):
        params = ckpt.restore_params(log_dir, run_name, template)
        print(f"frozen model restored from {run_name}")
        return params
    print(f"frozen checkpoint {run_name!r} not found; fresh init")
    return template


def load_frames_split(cfg: LoopConfig, is_train: bool):
    d = cfg.data
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        from pose3d_tpu.cli.train_direct import load_image_split
        from pose3d_tpu.config import DirectConfig

        dcfg = DirectConfig(log_dir=cfg.log_dir, image_size=cfg.image_size,
                            data=d)
        frames, kp3d, _ = load_image_split(dcfg, is_train)
        # 2D targets must come from the SAME subjects/ordering as the frames
        # (load_image_split uses the S1/S11 convention of train_3.py:41-42)
        subjects = ("S1",) if is_train else ("S11",)
        kp2d, _, _, _ = h36m.read_data(d.data_dir, subjects, d.action)
        if d.split_rate:
            kp2d = kp2d[::d.split_rate]
        assert len(kp2d) >= len(frames), (len(kp2d), len(frames))
        return frames, kp2d[: len(frames)], kp3d
    n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, 8)
    kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
    kp3d = kp3d - kp3d[:, :1]
    frames = synthetic.synthetic_frames(n, cfg.image_size,
                                        seed=4 if is_train else 5)
    return frames, kp2d, kp3d


def train(cfg: LoopConfig):
    dtype = jnp.bfloat16 if cfg.bf16 else jnp.float32
    model2d = PoseNet2D(architecture=cfg.architecture, dtype=dtype)
    model3d = PoseNet3D(architecture=cfg.architecture, dtype=dtype,
                        return_heatmap=True)
    lifter = JointTransformerLifter()
    projector = JointTransformerLifter(in_dim=3, out_dim=2)

    frames, kp2d, kp3d = load_frames_split(cfg, True)
    vframes, vkp2d, vkp3d = load_frames_split(cfg, False)

    mesh = make_mesh()
    img0 = jnp.zeros((2, cfg.image_size, cfg.image_size, 3))
    state = LoopState(
        net2d=create_train_state(model2d, jax.random.key(cfg.seed), img0,
                                 lr=cfg.lr),
        net3d=create_train_state(model3d, jax.random.key(cfg.seed + 1), img0,
                                 lr=cfg.lr),
        lifter_params=_load_frozen(
            lifter, jnp.zeros((2, 17, 2)), cfg.log_dir, cfg.lifter_checkpoint
        ) if cfg.triangle else None,
        projector_params=_load_frozen(
            projector, jnp.zeros((2, 17, 3)), cfg.log_dir,
            cfg.projector_checkpoint,
        ) if cfg.project else None,
    )
    state = jax.device_put(state, replicated(mesh))

    step = make_loop_train_step(
        lifter.apply, projector.apply, triangle=cfg.triangle, flip=cfg.flip,
        project=cfg.project, triangle_mode=cfg.triangle_mode,
    )
    eval_step = make_loop_eval_step(flip=cfg.flip)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.architecture,
        "dataset": "H3.6", "epochs": cfg.n_epochs,
        "triangle": cfg.triangle, "flip": cfg.flip, "project": cfg.project,
    })

    n_train = (len(frames) // cfg.batch_size) * cfg.batch_size
    try:
      for epoch in range(cfg.n_epochs):
          it = prefetch_to_device(
              batch_iterator((frames, kp2d, kp3d), cfg.batch_size, shuffle=True,
                             seed=cfg.seed + epoch, epochs=1), mesh,
          )
          loss_acc, sums_acc, term_acc, last = [], [], [], None
          for i, (f, y1, y2) in enumerate(it):
              state, m = step(state, f, y1, y2,
                              jax.random.key(epoch * 7919 + i))
              loss_acc.append(m["loss"])
              sums_acc.append(m["mpjpe_sums"])
              term_acc.append({k: v for k, v in m.items()
                               if k.startswith("loss_")})
              last = m["loss"]
          state = loop_plateau_step(state, last)

          vit = prefetch_to_device(
              batch_iterator((vframes, vkp2d, vkp3d), cfg.batch_size,
                             shuffle=False, epochs=1), mesh,
          )
          vloss, vsums, n_val = [], [], 0
          for f, y1, y2 in vit:
              vm = eval_step(state, f, y1, y2)
              vloss.append(vm["loss"])
              vsums.append(vm["mpjpe_sums"])
              n_val += f.shape[0]

          # per-term averages (reference TriangleLoss.report_losses,
          # losses.py:55-62) ride along in the JSONL record
          terms = {k: float(jnp.mean(jnp.stack([t[k] for t in term_acc])))
                   for k in term_acc[0]} if term_acc else {}
          logger.log_epoch(
              epoch, cfg.n_epochs,
              float(jnp.mean(jnp.stack(loss_acc))),
              float(losses.mpjpe_mm(jnp.sum(jnp.stack(sums_acc), 0), n_train)),
              float(jnp.mean(jnp.stack(vloss))),
              float(losses.mpjpe_mm(jnp.sum(jnp.stack(vsums), 0), n_val)),
              lr=float(state.net3d.plateau.lr), **terms,
          )

    except KeyboardInterrupt:
        ckpt.save(state.net2d, cfg.log_dir, "interrupt_" + cfg.run_name + "_2d",
                  batch_size=cfg.batch_size)
        ckpt.save(state.net3d, cfg.log_dir, "interrupt_" + cfg.run_name + "_3d",
                  batch_size=cfg.batch_size)
        print("interrupted; saved interrupt checkpoints")
        raise

    p2 = ckpt.save(state.net2d, cfg.log_dir, cfg.run_name + "_2d",
                   batch_size=cfg.batch_size)
    p3 = ckpt.save(state.net3d, cfg.log_dir, cfg.run_name + "_3d",
                   batch_size=cfg.batch_size)
    logger.finish()
    print(f"saved {p2} and {p3}")
    return state


if __name__ == "__main__":
    train(parse_config(LoopConfig))
