"""End-to-end walkthrough: every capability of the framework in one script.

Runs hermetically (synthetic data, mock detector) on CPU or GPU:
  1. train a phase-1 lifter          (reference: phase1 train_1.py)
  2. train the projector             (reference: phase5 train_project.py)
  3. phase-5 consistency loop        (reference: phase5 train_5.py)
  4. direct image->3D                (reference: phase3 train_3.py)
  5. temporal sequence lifter        (reference: external MotionBERT)
  6. video -> keypoints -> 3D        (reference: phase2 run.py)
  7. serve the lifter                (new: production serving path)
  8. multi-device: DP serving + DP temporal training over the device
     mesh via shard_map  (new: parallel/ + train.steps)

Usage:  python examples/end_to_end.py [--cpu] [--workdir DIR]
"""

import argparse
import pathlib
import sys
import tempfile

import numpy as np

# allow running straight from a checkout: examples/.. is the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (fast smoke)")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    work = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="pose3d_"))
    logs = str(work / "logs")
    print(f"== workdir {work}, backend {jax.default_backend()} ==")

    from pose3d_tpu.config import DataConfig, LiftConfig, LoopConfig

    data = DataConfig(synthetic_frames=2048)

    print("\n[1/8] phase-1 lifter")
    from pose3d_tpu.cli.train_lift import train as train_lift

    lift_state = train_lift(LiftConfig(
        n_epochs=3, batch_size=128, run_name="lifter", log_dir=logs, data=data,
    ))

    print("\n[2/8] projector")
    from pose3d_tpu.cli.train_project import train as train_project

    train_project(LiftConfig(
        n_epochs=2, batch_size=128, run_name="projector", log_dir=logs,
        data=data,
    ))

    print("\n[3/8] phase-5 consistency loop (triangle + flip + project)")
    from pose3d_tpu.cli.train_loop import train as train_loop

    train_loop(LoopConfig(
        n_epochs=1, batch_size=8, run_name="loop", log_dir=logs,
        architecture="resnet18", image_size=64, bf16=False,
        triangle=True, flip=True, project=True,
        lifter_checkpoint="lifter", projector_checkpoint="projector",
        data=DataConfig(synthetic_frames=64),
    ))

    print("\n[4/8] direct image->3D (phase 3)")
    from pose3d_tpu.cli.train_direct import infer, train as train_direct
    from pose3d_tpu.config import DirectConfig

    dcfg = DirectConfig(
        architecture="resnet18", n_epochs=2, batch_size=16, chunk_steps=2,
        run_name="direct", log_dir=logs, image_size=64, bf16=False,
        data=DataConfig(synthetic_frames=128),
    )
    train_direct(dcfg)
    infer(dcfg)

    print("\n[5/8] temporal sequence lifter (243-frame capability, small here)")
    from pose3d_tpu.cli.train_temporal import train as train_temporal
    from pose3d_tpu.config import TemporalConfig

    train_temporal(TemporalConfig(
        clip_len=16, hidden=64, n_blocks=2, heads=4, batch_size=8,
        n_epochs=2, run_name="temporal", log_dir=logs,
        data=DataConfig(synthetic_frames=512),
    ))

    print("\n[6/8] video -> keypoints -> 3D pipeline")
    from pose3d_tpu.pipeline.detector import MockDetector
    from pose3d_tpu.pipeline.run import process_video
    from pose3d_tpu.pipeline.video import write_video
    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.train import checkpoint as ckpt
    from pose3d_tpu.train.state import create_train_state

    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    (work / "videos" / "raw_videos").mkdir(parents=True, exist_ok=True)
    write_video(iter((rng.random((20, 64, 64, 3)) * 255).astype(np.uint8)),
                work / "videos" / "raw_videos" / "demo.mp4", fps=10)
    lifter = TemporalLifter(clip_len=16, hidden=64, n_blocks=2, heads=4)
    tstate = create_train_state(lifter, jax.random.key(0),
                                jnp.zeros((1, 16, 17, 2)), lr=1e-3)
    tstate, _ = ckpt.restore(tstate, logs, "temporal")
    poses = process_video("demo.mp4", work / "videos", MockDetector(),
                          lifter, tstate.params, fps=100)
    print(f"pipeline output: {poses.shape} ->",
          work / "videos" / "MB_npy" / "demo.mp4.npy")

    print("\n[6b/8] REAL detection: trained PoseNet2D on a rendered video")
    # the video's frames are rendered ON DEVICE from known poses, so the
    # whole detect->lift path gets a measurable accuracy number (the
    # reference never quantifies its openpifpaf+MotionBERT pipeline)
    from pose3d_tpu.cli.train_detector import train as train_detector
    from pose3d_tpu.config import DetectorConfig
    from pose3d_tpu.data.synthetic import render_pose_frames, synthetic_h36m
    from pose3d_tpu.pipeline.detector import PoseNet2DDetector
    from pose3d_tpu.pipeline.keypoints import load_video_json

    on_gpu = jax.default_backend() == "gpu"
    det_state, det_px = train_detector(DetectorConfig(
        run_name="detector", log_dir=logs, architecture="resnet18",
        n_steps=240 if on_gpu else 24, chunk_steps=8, batch_size=8,
        n_train=512, n_eval=64, bf16=on_gpu))
    gt2d, gt3d = synthetic_h36m(20, seed=5)
    frames = np.asarray(render_pose_frames(gt2d, jax.random.key(5)))
    write_video(iter((frames * 255).astype(np.uint8)),
                work / "videos" / "raw_videos" / "skel.mp4", fps=10)
    poses = process_video(
        "skel.mp4", work / "videos",
        PoseNet2DDetector(det_state, batch_size=8),
        lifter, tstate.params, fps=100, already_h36m=True)
    det2d, _, _ = load_video_json(
        work / "videos" / "final_json_outputs" / "skel.mp4.json")
    det_err_px = float(np.linalg.norm(det2d / 1000.0 - gt2d,
                                      axis=-1).mean() * 256)
    gt3d_c = gt3d - gt3d[:, :1]
    mpjpe_mm = float(np.linalg.norm(
        (poses - poses[:, :1]) - gt3d_c, axis=-1).mean() * 1000)
    print(f"REAL pipeline accuracy: detection {det_err_px:.1f}px @256, "
          f"lifted MPJPE {mpjpe_mm:.1f}mm vs synthetic GT")

    print("\n[7/8] serving")
    from pose3d_tpu.models.lifters import JointTransformerLifter
    from pose3d_tpu.serving import LifterService
    from pose3d_tpu.train.checkpoint import restore_params

    model = JointTransformerLifter()
    template = model.init({"params": jax.random.key(0)},
                          jnp.zeros((1, 17, 2)), train=False)["params"]
    params = restore_params(logs, "lifter", template)
    svc = LifterService(model, params, max_batch=512, min_bucket=64)
    out = svc.lift(rng.random((300, 17, 2)).astype(np.float32))
    print(f"served {out.shape}; all artifacts under {work}")

    print("\n[8/8] multi-device (mesh) paths")
    import jax

    from pose3d_tpu.parallel.mesh import make_mesh
    from pose3d_tpu.train.steps import make_dp_lifter_train_step

    mesh = make_mesh()
    n = mesh.devices.size
    svc_dp = LifterService(model, params, max_batch=512, min_bucket=8 * n,
                           mesh=mesh)
    out_dp = svc_dp.lift(rng.random((100, 17, 2)).astype(np.float32))
    print(f"DP serving over {n} device(s): {out_dp.shape}")
    # shard_map DP training: each device runs the one-device step on its
    # shard, grads pmean over the data axis
    from pose3d_tpu.models.temporal import TemporalLifter as TL

    dp_model = TL(clip_len=12, hidden=64, n_blocks=1, heads=4)
    dstate = create_train_state(dp_model, jax.random.key(3),
                                jnp.zeros((n, 12, 17, 2)), lr=1e-3)
    dp_step = make_dp_lifter_train_step(mesh, donate=False)
    dstate, dm = dp_step(
        dstate, jnp.asarray(rng.random((n, 12, 17, 2), np.float32)),
        jnp.asarray(rng.random((n, 12, 17, 3), np.float32) - 0.5),
        jax.random.key(4))
    print(f"DP temporal train step over {n} device(s): "
          f"loss {float(dm['loss']):.4f}")
    print("\n== DONE ==")


if __name__ == "__main__":
    sys.exit(main())
