"""Video -> 2D keypoints -> 3D lifting orchestration (phase-2 equivalent).

Drives the full ETL of phase2_opp_mb/run.py:453-472 with the same directory
layout (raw_videos/, ffmpeg_frames/, opp_outputs/<video>/jsons_force/,
final_json_outputs/, MB_npy/) but: in-process video decode, a batched
detector interface (one invocation per video, not per frame), and the native
temporal lifter replacing the external MotionBERT hand-off.

Usage:
  python -m pose3d_tpu.pipeline.run --video my.mp4 --root ./videos \
      --detector mock --lifter_checkpoint temporal_run --fps 10
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np


def process_video(video: str, root, detector, lifter=None,
                  lifter_params=None, fps: float = 10.0,
                  render: bool = False, already_h36m: bool = False):
    """Run the staged pipeline for one video under ``root``."""
    from pose3d_tpu.pipeline import keypoints as kp_lib
    from pose3d_tpu.pipeline import video as video_lib

    root = pathlib.Path(root)
    frames_dir = root / "ffmpeg_frames" / video
    jsons_dir = root / "opp_outputs" / video / "jsons_force"
    final_json = root / "final_json_outputs" / f"{video}.json"
    npy_out = root / "MB_npy" / f"{video}.npy"

    if (root / "raw_videos" / video).exists():
        n = video_lib.extract_frames(root / "raw_videos" / video, frames_dir, fps)
        print(f"frames: {n}")
    assert frames_dir.exists(), f"no frames at {frames_dir}"

    detector.detect_dir(frames_dir, jsons_dir)
    records = kp_lib.save_to_json(jsons_dir, final_json, already_h36m)
    print(f"detections: {len(records)} frames -> {final_json}")

    poses = None
    if lifter is not None:
        from pose3d_tpu.pipeline.lift import lift_video_json

        poses = lift_video_json(lifter_params, lifter, final_json, npy_out)
        print(f"lifted: {poses.shape} -> {npy_out}")

    if render:
        from pose3d_tpu.utils.visualize import render_2d_video, render_3d_video

        render_2d_video(final_json, frames_dir,
                        root / "opp_2d_frames" / video / "out.mp4", fps)
        if poses is not None:
            # reference convention (run.py:305-352): camera->global rotation
            # via the S1-cam2 quaternion (:312-316, :336) then x2.8 (:343);
            # root-centring is commented out there (:339-341), so none here
            render_3d_video(poses, root / "MB_3d_frames" / video / "out.mp4",
                            fps, scale=2.8, to_global=True)
    return poses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--root", default="./videos")
    p.add_argument("--detector", default="mock",
                   choices=["mock", "openpifpaf", "posenet2d"])
    p.add_argument("--detector_checkpoint", default=None,
                   help="run name of a cli.train_detector checkpoint; "
                        "without it the posenet2d route is a fresh init")
    p.add_argument("--lifter_checkpoint", default=None)
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--render", action="store_true")
    args = p.parse_args(argv)

    from pose3d_tpu.pipeline.detector import MockDetector, OpenPifPafDetector

    already_h36m = False
    if args.detector == "mock":
        detector = MockDetector()
    elif args.detector == "openpifpaf":
        detector = OpenPifPafDetector()
    else:
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.models.heads import PoseNet2D
        from pose3d_tpu.pipeline.detector import PoseNet2DDetector
        from pose3d_tpu.train import checkpoint as ckpt
        from pose3d_tpu.train.state import create_train_state

        meta = (ckpt.load_meta(args.log_dir, args.detector_checkpoint)
                if args.detector_checkpoint else {})
        model = PoseNet2D(
            architecture=meta.get("architecture", "resnet50"),
            dtype=jnp.bfloat16 if meta.get("bf16") else jnp.float32,
        )
        state = create_train_state(
            model, jax.random.key(0), jnp.zeros((1, 256, 256, 3)), lr=1e-3
        )
        if args.detector_checkpoint and ckpt.exists(
                args.log_dir, args.detector_checkpoint):
            state, _ = ckpt.restore(state, args.log_dir,
                                    args.detector_checkpoint)
            print(f"detector restored from {args.detector_checkpoint} "
                  f"({meta.get('architecture')}, "
                  f"eval_px_err {meta.get('eval_px_err', '?')})")
        elif args.detector_checkpoint:
            print(f"detector checkpoint {args.detector_checkpoint} not "
                  "found; using fresh init")
        detector = PoseNet2DDetector(state)
        already_h36m = True

    lifter = lifter_params = None
    if args.lifter_checkpoint:
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.models.temporal import TemporalLifter
        from pose3d_tpu.train import checkpoint as ckpt
        from pose3d_tpu.train.state import create_train_state

        # serving path: bf16 compute
        lifter = TemporalLifter(dtype=jnp.bfloat16)
        state = create_train_state(
            lifter, jax.random.key(0),
            jnp.zeros((1, lifter.clip_len, 17, 2)), lr=1e-3,
        )
        if ckpt.exists(args.log_dir, args.lifter_checkpoint):
            state, _ = ckpt.restore(state, args.log_dir, args.lifter_checkpoint)
            print(f"lifter restored from {args.lifter_checkpoint}")
        else:
            print("lifter checkpoint not found; using fresh init")
        lifter_params = state.params

    process_video(args.video, args.root, detector, lifter, lifter_params,
                  args.fps, args.render, already_h36m)
    print("___DONE___")


if __name__ == "__main__":
    main()
