"""Native 2D detector: on-device skeleton rendering + PoseNet2D training
+ the REAL (non-mock) detection route through the video pipeline.

Covers the capability the reference gets from the external openpifpaf
checkpoint (phase2_opp_mb/run.py:134-166): here the detector is trained
in-framework (cli/train_detector.py) on frames rendered inside the jitted
step, and the pipeline runs detect->json->lift with measurable accuracy.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.config import DetectorConfig
from pose3d_tpu.data.synthetic import render_pose_frames, synthetic_h36m

SIZE = 64


def _tiny_cfg(tmp_path, **kw):
    kw.setdefault("architecture", "resnet18")
    kw.setdefault("image_size", SIZE)
    kw.setdefault("n_steps", 24)
    kw.setdefault("chunk_steps", 4)
    kw.setdefault("batch_size", 4)
    kw.setdefault("n_train", 128)
    kw.setdefault("n_eval", 16)
    kw.setdefault("bf16", False)
    kw.setdefault("run_name", "det_test")
    return DetectorConfig(log_dir=str(tmp_path / "logs"), **kw)


class TestRenderer:
    def test_blobs_land_on_joints(self, rng):
        kp2d, _ = synthetic_h36m(3, seed=2)
        frames = np.asarray(jax.jit(render_pose_frames, static_argnums=2)(
            kp2d, jax.random.key(0), SIZE))
        assert frames.shape == (3, SIZE, SIZE, 3)
        assert frames.min() >= 0.0 and frames.max() <= 1.0
        # every joint pixel is far brighter than the background level (at
        # 64px neighbouring blobs overlap, so argmax-in-window is too
        # strict — brightness at the exact joint location is the invariant)
        lum = frames.sum(-1)
        for f in range(3):
            bg = np.median(lum[f])
            for j in range(17):
                x, y = np.clip((kp2d[f, j] * SIZE).astype(int), 0, SIZE - 1)
                assert lum[f, y, x] > bg + 0.5, (f, j, lum[f, y, x], bg)

    def test_deterministic_given_key(self):
        kp2d, _ = synthetic_h36m(2, seed=3)
        a = render_pose_frames(kp2d, jax.random.key(1), SIZE)
        b = render_pose_frames(kp2d, jax.random.key(1), SIZE)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestDetectorTraining:
    @pytest.mark.slow
    def test_short_training_beats_fresh_init(self, tmp_path):
        from pose3d_tpu.cli.train_detector import build_detector, train
        from pose3d_tpu.train.image_steps import make_detector_eval_step
        from pose3d_tpu.train.state import create_train_state

        cfg = _tiny_cfg(tmp_path)
        init_state = create_train_state(
            build_detector(cfg), jax.random.key(cfg.seed),
            jnp.zeros((cfg.batch_size, SIZE, SIZE, 3)), lr=cfg.lr)
        kp2d_eval, _ = synthetic_h36m(cfg.n_eval, seed=cfg.seed + 1)
        kb = cfg.n_eval // cfg.batch_size
        kp2d_eval = jnp.asarray(
            kp2d_eval[: kb * cfg.batch_size].reshape(kb, cfg.batch_size, 17, 2))
        eval_fn = make_detector_eval_step(SIZE)
        init_px = float(eval_fn(init_state, kp2d_eval, jax.random.key(99)))

        state, trained_px = train(cfg)
        assert int(state.step) == cfg.n_steps
        assert np.isfinite(trained_px)
        assert trained_px < init_px, (trained_px, init_px)
        # quantified bound: 16 CPU steps at this config demonstrated
        # 8.6 px eval error — 16 px is ~2x margin over the demonstrated
        # value, 2x tighter than init
        assert trained_px < SIZE / 4, trained_px
        # checkpoint written with the metadata the pipeline CLI reads
        from pose3d_tpu.train import checkpoint as ckpt

        meta = ckpt.load_meta(cfg.log_dir, cfg.run_name)
        assert meta["model"] == "posenet2d"
        assert meta["architecture"] == "resnet18"


class TestRealDetectionPipeline:
    @pytest.mark.slow
    def test_process_video_with_trained_posenet(self, tmp_path, rng):
        """Non-mock end-to-end: rendered video -> trained PoseNet2D ->
        save_to_json -> finite detection pixel error vs the known GT."""
        from pose3d_tpu.cli.train_detector import train
        from pose3d_tpu.pipeline.detector import PoseNet2DDetector
        from pose3d_tpu.pipeline.keypoints import load_video_json
        from pose3d_tpu.pipeline.run import process_video
        from pose3d_tpu.pipeline.video import write_video

        cfg = _tiny_cfg(tmp_path, n_steps=16)
        state, _ = train(cfg)

        gt2d, _ = synthetic_h36m(8, seed=5)
        frames = np.asarray(render_pose_frames(gt2d, jax.random.key(5), SIZE))
        root = tmp_path / "videos"
        (root / "raw_videos").mkdir(parents=True)
        write_video(iter((frames * 255).astype(np.uint8)),
                    root / "raw_videos" / "skel.mp4", fps=10)

        process_video("skel.mp4", root,
                      PoseNet2DDetector(state, image_size=SIZE, batch_size=4),
                      already_h36m=True)
        det2d, conf, _ = load_video_json(
            root / "final_json_outputs" / "skel.mp4.json")
        assert det2d.shape == (8, 17, 2)
        err_px = np.linalg.norm(det2d / 1000.0 - gt2d, axis=-1).mean() * SIZE
        assert np.isfinite(err_px)
        # demonstrated bound: this 16-step config reaches ~8.6 px eval
        # error on clean frames; SIZE/4 = 16 px leaves ~2x margin for the
        # mp4 encode/decode round-trip the video path adds
        assert err_px < SIZE / 4, err_px
