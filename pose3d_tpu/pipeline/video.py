"""Video decode / frame extraction / encode.

Reference behavior (phase2_opp_mb/run.py:113-131 ``run_ffmpeg``): one ffmpeg
subprocess per video extracting fps-resampled frames to ``ffmpeg_frames/
<video>/%04d.jpg`` plus a reduced-fps mp4.

Redesign: decode in-process through cv2's native codecs (no
per-video shell-out; this image has no ffmpeg binary) with the same output
layout. Frames can stream straight to device without touching JPEG disk
round-trips via :func:`iter_frames`.
"""

from __future__ import annotations

import pathlib

import cv2
import numpy as np


def iter_frames(video_path, fps: float | None = None):
    """Yield RGB float frames resampled to ``fps`` (None = native rate)."""
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = 1.0 if fps is None else max(native_fps / fps, 1.0)
    next_keep = 0.0
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i >= next_keep:
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            next_keep += step
        i += 1
    cap.release()


def extract_frames(video_path, out_dir, fps: float = 10.0) -> int:
    """Decode a video to ``out_dir/%04d.jpg`` at ``fps`` (reference layout:
    1-based zero-padded names, run.py:128). Returns the frame count.

    Prefers the native C++ decoder (pose3d_tpu/native/video.cc — no Python
    in the frame path; identical frame selection and pixels); falls back to
    the in-process cv2 loop.
    """
    from pose3d_tpu.data import native_video

    if native_video.native_available():
        return native_video.extract_jpegs(video_path, out_dir, fps=fps)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for frame in iter_frames(video_path, fps):
        n += 1
        cv2.imwrite(str(out / f"{n:04d}.jpg"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return n


def run_ffmpeg(videos, raw_dir, frames_dir, reduced_dir=None, fps: float = 10.0):
    """Reference-API entry (run.py:113-131): extract frames for each video
    under ``frames_dir/<video>/``; optionally write a reduced-fps mp4."""
    raw_dir = pathlib.Path(raw_dir)
    for video in videos:
        n = extract_frames(raw_dir / video, pathlib.Path(frames_dir) / video, fps)
        if reduced_dir is not None:
            frames = sorted((pathlib.Path(frames_dir) / video).glob("*.jpg"))
            write_video(
                (cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in frames),
                pathlib.Path(reduced_dir) / f"{video}_fps.mp4", fps,
            )
        print(f"extracted {n} frames from {video}")


def write_video(rgb_frames, out_path, fps: float = 10.0) -> int:
    """Encode an iterable of RGB uint8 frames to mp4 (cv2 native encoder;
    replaces the reference's ffmpeg -framerate glob encode, run.py:297-299)."""
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    writer = None
    n = 0
    for frame in rgb_frames:
        if writer is None:
            h, w = frame.shape[:2]
            writer = cv2.VideoWriter(
                str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
        writer.write(cv2.cvtColor(np.asarray(frame, np.uint8), cv2.COLOR_RGB2BGR))
        n += 1
    if writer is not None:
        writer.release()
    return n


def load_frames(frames_dir, size: int | None = None, dtype=np.float32):
    """Load ``%04d.jpg`` frames as one (N, H, W, 3) array, optionally
    resized. dtype float32 (default): values in [0,1) per the resize-256 +
    /256 convention of H36_dataset.py:129-131. dtype uint8: raw pixels —
    callers normalize on device (``x/256`` of uint8 is exact in f32, and
    the host->device transfer is 4x smaller)."""
    files = sorted(pathlib.Path(frames_dir).glob("*.jpg"))
    frames = []
    for f in files:
        img = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
        if size is not None:
            img = cv2.resize(img, (size, size))
        frames.append(img if dtype == np.uint8
                      else img.astype(np.float32) / 256.0)
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), dtype)
