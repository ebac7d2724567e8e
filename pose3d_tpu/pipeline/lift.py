"""Sequence lifting inference: video 2D-keypoint JSON -> (T,17,3) npy.

Replaces the reference's manual external hand-off
(``python3 infer_wild.py --vid_path ... --json_path ... --out_path``,
run.py:475-478) with the native temporal transformer: keypoints are
normalized to image coordinates, chunked into overlapping clips, lifted in
one batched jitted call, and the overlapping predictions averaged back into
a (T,17,3) float32 sequence saved in the MB_npy interchange format.
"""

from __future__ import annotations

import functools

import numpy as np

from pose3d_tpu.models.temporal import TemporalLifter, make_clips
from pose3d_tpu.pipeline.keypoints import load_video_json, save_mb_npy


@functools.cache
def _infer():
    """One module-level jit: defining it inside lift_sequence would make
    every call a fresh callable and recompile the forward per video."""
    import jax

    def infer(model, p, x):
        return model.apply({"params": p}, x, train=False)

    return jax.jit(infer, static_argnums=0)  # models hash by config


def lift_sequence(params, model: TemporalLifter, kp2d_px: np.ndarray,
                  image_size: float = 1000.0, stride: int | None = None):
    """(T,17,2) pixel keypoints -> (T,17,3) lifted sequence.

    Clips of ``model.clip_len`` frames with ``stride`` overlap (default:
    clip_len//2); overlapping frame predictions are averaged; every frame
    is covered (``clip_starts`` anchors a final window at the tail). The
    clips run in ``model.dtype``.
    """
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import clip_starts

    t_total = kp2d_px.shape[0]
    if t_total == 0:
        return np.zeros((0, 17, 3), np.float32)
    clip_len = min(model.clip_len, t_total)
    stride = stride or max(clip_len // 2, 1)
    kp = (kp2d_px / image_size).astype(np.float32)

    clips = make_clips(kp, clip_len, stride)
    out = np.asarray(_infer()(model, params, jnp.asarray(clips)))

    acc = np.zeros((t_total, 17, 3), np.float32)
    cnt = np.zeros((t_total, 1, 1), np.float32)
    for c, s in zip(out, clip_starts(t_total, clip_len, stride)):
        end = min(s + clip_len, t_total)
        acc[s:end] += c[: end - s]
        cnt[s:end] += 1.0
    assert cnt.min() >= 1.0, "internal: some frame covered by no clip"
    return acc / cnt


def lift_video_json(params, model: TemporalLifter, json_path, out_npy_path,
                    image_size: float = 1000.0):
    kp2d, _, _ = load_video_json(json_path)
    poses = lift_sequence(params, model, kp2d, image_size)
    save_mb_npy(poses, out_npy_path)
    return poses
