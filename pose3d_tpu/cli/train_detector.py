"""Train the native 2D detector so the video pipeline detects for real.

The reference's pipeline leans on an external openpifpaf checkpoint
(phase2_opp_mb/run.py:134-166); this framework's equivalent capability is
``PoseNet2D`` (the phase-5 ``Model_2D``, phase5_loop/Model_2d.py:13-138)
behind ``pipeline/detector.py::PoseNet2DDetector``. This trainer gives that
route real weights: it distills image->keypoints on frames RENDERED ON
DEVICE from synthetic H36M-like poses (``data/synthetic.py::
render_pose_frames``) — a closed world where detection quality is exactly
measurable (pixel error), and the full video->3D path runs "in anger"
without any external model. Swap ``--data`` poses for real H36M frames by
training ``cli/train_loop`` instead once the dataset is present.

Usage:
  python -m pose3d_tpu.cli.train_detector --run_name det1 --n_steps 600
  python -m pose3d_tpu.pipeline.run --video v.mp4 --detector posenet2d \
      --detector_checkpoint det1
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu.config import DetectorConfig, parse_config
from pose3d_tpu.data import synthetic
from pose3d_tpu.models.heads import PoseNet2D
from pose3d_tpu.train import checkpoint as ckpt
from pose3d_tpu.train.image_steps import (
    make_detector_chunk_step,
    make_detector_eval_step,
)
from pose3d_tpu.train.state import create_train_state


def build_detector(cfg: DetectorConfig):
    return PoseNet2D(
        architecture=cfg.architecture,
        dtype=jnp.bfloat16 if cfg.bf16 else jnp.float32,
    )


def train(cfg: DetectorConfig):
    model = build_detector(cfg)
    state = create_train_state(
        model, jax.random.key(cfg.seed),
        jnp.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3)),
        lr=cfg.lr, optimizer="adam", weight_decay=1e-8,
    )
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {int(state.step)}")

    # pose pool on host: only (N,17,2) keypoints — frames render on device
    kp2d_pool, _ = synthetic.synthetic_h36m(cfg.n_train, seed=cfg.seed)
    kp2d_eval, _ = synthetic.synthetic_h36m(cfg.n_eval, seed=cfg.seed + 1)
    kb = cfg.n_eval // cfg.batch_size
    kp2d_eval = jnp.asarray(
        kp2d_eval[: kb * cfg.batch_size]
        .reshape(kb, cfg.batch_size, 17, 2))

    step_fn = make_detector_chunk_step(cfg.image_size)
    eval_fn = make_detector_eval_step(cfg.image_size)
    rng = np.random.default_rng(cfg.seed)
    k, b = cfg.chunk_steps, cfg.batch_size

    t0 = time.time()
    done = 0
    while done < cfg.n_steps:
        idx = rng.integers(0, len(kp2d_pool), size=(k, b))
        state, m = step_fn(state, jnp.asarray(kp2d_pool[idx]),
                           jax.random.key(cfg.seed * 7919 + done))
        done += k
        if done % (k * 8) == 0 or done >= cfg.n_steps:
            px = float(eval_fn(state, kp2d_eval, jax.random.key(99)))
            print(f"step {done}/{cfg.n_steps} loss {float(m['loss']):.5f} "
                  f"train_px {float(m['px_err']):.2f} eval_px {px:.2f} "
                  f"({time.time() - t0:.0f}s)")

    path = ckpt.save(state, cfg.log_dir, cfg.run_name,
                     batch_size=cfg.batch_size,
                     extra={"model": "posenet2d",
                            "architecture": cfg.architecture,
                            "bf16": cfg.bf16,
                            "eval_px_err": px})
    print(f"saved {path} (eval pixel error {px:.2f}px @ {cfg.image_size})")
    return state, px


def main(argv=None):
    train(parse_config(DetectorConfig, argv))


if __name__ == "__main__":
    main()
