"""Inference CLI: lift 2D keypoints to 3D with a trained checkpoint.

Covers the reference's ad-hoc inference surfaces in one place:
- keypoints npy/JSON -> per-frame lifting with a phase-1 checkpoint
  (the eval half of train_1.py), or
- sequence lifting with a temporal checkpoint (the MotionBERT hand-off,
  run.py:475-478), writing the (T,17,3) MB_npy interchange format.

Usage:
  python -m pose3d_tpu.cli.predict --checkpoint lift_run --model vit \
      --input kp2d.npy --output kp3d.npy
  python -m pose3d_tpu.cli.predict --checkpoint t1 --model temporal \
      --input video.json --output MB_npy/video.npy
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="vit",
                   choices=["vit", "martinez", "ae", "temporal"])
    p.add_argument("--input", required=True,
                   help="(N,17,2) npy, or a pipeline video JSON")
    p.add_argument("--output", required=True)
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--image_size", type=float, default=1000.0,
                   help="pixel scale when reading a video JSON")
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads of a temporal checkpoint; default "
                        "reads the checkpoint's .meta.json sidecar (written "
                        "at train time — heads is not recoverable from "
                        "param shapes), falling back to 8")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train import checkpoint as ckpt

    inp = pathlib.Path(args.input)
    if inp.suffix == ".json":
        from pose3d_tpu.pipeline.keypoints import load_video_json

        kp2d, _, _ = load_video_json(inp)
        kp2d = kp2d / args.image_size
    else:
        kp2d = np.load(inp).astype(np.float32)
    assert kp2d.ndim == 3 and kp2d.shape[1:] == (17, 2), kp2d.shape

    if args.model == "temporal":
        from pose3d_tpu.models.temporal import TemporalLifter
        from pose3d_tpu.pipeline.lift import lift_sequence

        # infer the architecture from the checkpoint itself — a template
        # built from defaults breaks on any non-default checkpoint. heads
        # is the one field param shapes can't recover: the trainer persists
        # it in the .meta.json sidecar; --heads overrides.
        params = ckpt.peek_params(args.log_dir, args.checkpoint)
        meta = ckpt.load_meta(args.log_dir, args.checkpoint)
        heads = args.heads if args.heads is not None else meta.get("heads", 8)
        model = TemporalLifter(
            hidden=int(params["Dense_0"]["kernel"].shape[1]),
            n_blocks=sum(1 for k in params
                         if str(k).startswith("SpatioTemporalBlock_")),
            clip_len=int(params["temporal_pe"].shape[1]),
            n_joints=int(params["spatial_pe"].shape[2]),
            heads=heads,
        )
        poses = lift_sequence(params, model, kp2d * args.image_size,
                              image_size=args.image_size)
    else:
        from pose3d_tpu.cli.train_lift import build_lifter

        model = build_lifter(args.model)
        variables = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((1, 17, 2)), train=True,
        )
        batch_stats = variables.get("batch_stats", {})
        if batch_stats:
            params, batch_stats = ckpt.restore_params(
                args.log_dir, args.checkpoint, variables["params"], batch_stats
            )
        else:
            params = ckpt.restore_params(
                args.log_dir, args.checkpoint, variables["params"]
            )

        @jax.jit
        def fwd(params, x):
            v = {"params": params}
            if batch_stats:
                v["batch_stats"] = batch_stats
            return model.apply(v, x, train=False)

        chunks = []
        bs = args.batch_size
        for s in range(0, len(kp2d), bs):
            chunk = kp2d[s:s + bs]
            pad = 0
            if len(chunk) < bs and s > 0:
                pad = bs - len(chunk)
                chunk = np.concatenate([chunk, np.zeros((pad, 17, 2), np.float32)])
            out = np.asarray(fwd(params, jnp.asarray(chunk)))
            out = out.reshape(-1, 17, 3)
            chunks.append(out[: len(out) - pad] if pad else out)
        poses = np.concatenate(chunks)

    out_path = pathlib.Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, poses.astype(np.float32))
    print(f"lifted {poses.shape} -> {out_path}")


if __name__ == "__main__":
    main()
