"""Temporal sequence-lifter trainer (BASELINE config #3).

Trains the native MotionBERT-style spatio-temporal transformer on 243-frame
keypoint clips — the capability the reference delegates to the external
MotionBERT repo (run.py:475-478). Data: H36M keypoint sequences (or the
synthetic fallback) windowed into clips; optionally existing MB_npy video
artifacts can seed 2D inputs through the pipeline.

Usage:
  python -m pose3d_tpu.cli.train_temporal --run_name t1 --clip_len 243
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu import losses
from pose3d_tpu.config import TemporalConfig, parse_config
from pose3d_tpu.data import synthetic
from pose3d_tpu.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu.models.temporal import TemporalLifter, make_clips
from pose3d_tpu.parallel.mesh import make_mesh, replicated
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.logging import MetricLogger
from pose3d_tpu.train.schedule import plateau_update
from pose3d_tpu.train.state import create_train_state
from pose3d_tpu.train.steps import make_lifter_eval_step, make_lifter_train_step


def load_clips(cfg: TemporalConfig, is_train: bool):
    d = cfg.data
    import pathlib

    if d.data_dir and pathlib.Path(d.data_dir).exists():
        from pose3d_tpu.data import h36m

        subjects = d.train_subjects if is_train else d.test_subjects
        kp2d, kp3d, _, _ = h36m.read_data(d.data_dir, subjects, d.action)
        kp3d = kp3d - kp3d[:, :1]
    else:
        n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, cfg.clip_len)
        kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
        kp3d = kp3d - kp3d[:, :1]
    stride = cfg.clip_len if is_train else cfg.clip_len
    c2 = make_clips(kp2d, cfg.clip_len, stride)
    c3 = make_clips(kp3d, cfg.clip_len, stride)
    return c2, c3


def train(cfg: TemporalConfig):
    model = TemporalLifter(clip_len=cfg.clip_len, hidden=cfg.hidden,
                           n_blocks=cfg.n_blocks, heads=cfg.heads,
                           dtype=jnp.bfloat16 if cfg.bf16 else jnp.float32)
    c2, c3 = load_clips(cfg, True)
    v2, v3 = load_clips(cfg, False)
    print(f"clips: train {c2.shape}, val {v2.shape}")

    mesh = make_mesh()
    state = create_train_state(
        model, jax.random.key(cfg.seed),
        jnp.zeros((2, cfg.clip_len, 17, 2)), lr=cfg.lr,
    )
    state = jax.device_put(state, replicated(mesh))
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed at step {int(state.step)}")

    # GSPMD data parallelism: the batch is sharded over the mesh's data
    # axis by the device feed, params are replicated
    step = make_lifter_train_step(cfg.loss)
    eval_step = make_lifter_eval_step(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": "temporal_transformer",
        "clip_len": cfg.clip_len, "epochs": cfg.n_epochs,
    })

    def per_mesh(n):
        # the device feed splits each batch evenly over the data axis
        n -= n % mesh.devices.size
        assert n > 0, f"batch smaller than the {mesh.devices.size} devices"
        return n

    bs = per_mesh(min(cfg.batch_size, len(c2)))
    n_train = (len(c2) // bs) * bs * cfg.clip_len
    for epoch in range(cfg.n_epochs):
        it = prefetch_to_device(
            batch_iterator((c2, c3), bs, shuffle=True, seed=cfg.seed + epoch,
                           epochs=1), mesh,
        )
        loss_acc, sums_acc, last = [], [], None
        for i, (y1, y2) in enumerate(it):
            state, m = step(state, y1, y2, jax.random.key(epoch * 97 + i))
            loss_acc.append(m["loss"])
            # per-clip mpjpe sums are (T,17) summed over batch: steps return
            # (J,)? loss_mpjpe sums over leading axes except joints/dim:
            sums_acc.append(m["mpjpe_sums"])
            last = m["loss"]
        state = state.replace(plateau=plateau_update(state.plateau, last))

        vit = prefetch_to_device(
            batch_iterator((v2, v3), per_mesh(min(bs, len(v2))), shuffle=False,
                           epochs=1), mesh,
        )
        vloss, vsums, n_val = [], [], 0
        for y1, y2 in vit:
            vm = eval_step(state, y1, y2)
            vloss.append(vm["loss"])
            vsums.append(vm["mpjpe_sums"])
            n_val += y1.shape[0] * cfg.clip_len
        logger.log_epoch(
            epoch, cfg.n_epochs,
            float(jnp.mean(jnp.stack(loss_acc))),
            float(losses.mpjpe_mm(jnp.sum(jnp.stack(sums_acc), 0), n_train)),
            float(jnp.mean(jnp.stack(vloss))),
            float(losses.mpjpe_mm(jnp.sum(jnp.stack(vsums), 0), n_val)),
            lr=float(state.plateau.lr),
        )

    # heads is NOT recoverable from param shapes (qkv/proj are head-count
    # independent) — persist it (and the shape-derivable fields, for
    # debuggability) in the .meta.json sidecar so cli.predict can rebuild
    # the exact architecture
    path = ckpt.save(
        state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size,
        extra={"heads": cfg.heads, "hidden": cfg.hidden,
               "n_blocks": cfg.n_blocks, "clip_len": cfg.clip_len},
    )
    logger.finish()
    print(f"saved {path}")
    return state


if __name__ == "__main__":
    train(parse_config(TemporalConfig))
