"""ctypes bindings for the C++ video decoder (pose3d_tpu/native/video.cc).

The native side decodes a video container straight into the caller's batch
buffer — centre-crop square, resize, RGB, uint8 or /256 float32 — the
Native replacement for the reference's ffmpeg-subprocess + per-frame
python cv2 pipeline (phase2 run.py:31-57, phase4
Custom_Video_dataset.py:44-73). Falls back to python cv2 transparently when
the shared library (or OpenCV C++) is unavailable, so nothing hard-depends
on the native path; both paths use the same codec/resize implementations,
so outputs are bit-identical.
"""

from __future__ import annotations

import ctypes
import logging
import pathlib

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libposevideo.so"
_lib = None
_log = logging.getLogger(__name__)


def _load_library():
    """CDLL the pre-built library; never builds as a side effect (build
    explicitly with ``python -m pose3d_tpu.data.native_build``). The
    fallback is logged once, not silently swallowed."""
    global _lib
    if _lib is not None:
        return _lib or None  # False = failed before; never retry per call
    if not _SO_PATH.exists():
        _lib = False
        _log.warning(
            "native video library %s not built; falling back to python cv2 "
            "(run `python -m pose3d_tpu.data.native_build` to build it)",
            _SO_PATH,
        )
        return None
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError as e:
        _lib = False
        _log.warning("native video library failed to load (%s); "
                     "falling back to python cv2", e)
        return None
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.vd_read_frames_u8.restype = ctypes.c_int
    lib.vd_read_frames_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vd_read_frames_f32.restype = ctypes.c_int
    lib.vd_read_frames_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vd_extract_jpegs.restype = ctypes.c_int
    lib.vd_extract_jpegs.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
    ]
    lib.vd_fps.restype = ctypes.c_double
    lib.vd_fps.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_library() is not None


def stream_video_frames(path, size: int = 256, chunk: int = 64,
                        stride: int = 1, dtype=np.uint8):
    """Generator of (n, size, size, 3) frame chunks (n <= ``chunk``; the
    last chunk may be short). Same pixel contract as ``read_video_frames``
    — centre-crop, resize, RGB — but yields as the decoder produces, so
    callers can overlap decode with device work (the e2e pipeline
    dispatches detection on chunk i while chunk i+1 decodes)."""
    path = str(path)
    lib = _load_library()
    if lib is not None:
        h = lib.vd_open(path.encode())
        if not h:
            raise FileNotFoundError(f"cannot open video {path}")
        try:
            while True:
                if dtype == np.uint8:
                    buf = np.empty((chunk, size, size, 3), np.uint8)
                    n = lib.vd_read_frames_u8(
                        h, size, stride, chunk,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                else:
                    buf = np.empty((chunk, size, size, 3), np.float32)
                    n = lib.vd_read_frames_f32(
                        h, size, stride, chunk,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if n > 0:
                    yield buf[:n]
                if n < chunk:
                    return
        finally:
            lib.vd_close(h)

    else:
        # python fallback: batch the cv2 loop to the same chunk contract
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        frames, idx = [], 0
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                if idx % stride:
                    idx += 1
                    continue
                idx += 1
                hh, ww = bgr.shape[:2]
                side = min(hh, ww)
                y0, x0 = (hh - side) // 2, (ww - side) // 2
                crop = bgr[y0:y0 + side, x0:x0 + side]
                if side != size:
                    crop = cv2.resize(crop, (size, size),
                                      interpolation=cv2.INTER_LINEAR)
                rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
                frames.append(rgb if dtype == np.uint8
                              else rgb.astype(np.float32) / 256.0)
                if len(frames) == chunk:
                    yield np.stack(frames)
                    frames = []
            if frames:
                yield np.stack(frames)
        finally:
            cap.release()


def read_video_frames(path, size: int = 256, stride: int = 1,
                      max_frames: int | None = None,
                      dtype=np.uint8) -> np.ndarray:
    """Decode a video to (N, size, size, 3) centre-cropped RGB frames.

    dtype uint8 (normalize-on-device path) or float32 ([0,1), the /256
    convention). Native C++ when available, python cv2 otherwise —
    bit-identical outputs either way.
    """
    path = str(path)
    lib = _load_library()
    if lib is not None:
        # chunked reads: container frame counts lie both ways (0 for some
        # encoders, under-reports for others) — never trust them for the
        # allocation, and never truncate before the decoder says EOF
        h = lib.vd_open(path.encode())
        if not h:
            raise FileNotFoundError(f"cannot open video {path}")
        chunks = []
        total = 0
        try:
            while max_frames is None or total < max_frames:
                want = 256
                if max_frames is not None:
                    want = min(want, max_frames - total)
                if dtype == np.uint8:
                    buf = np.empty((want, size, size, 3), np.uint8)
                    n = lib.vd_read_frames_u8(
                        h, size, stride, want,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                else:
                    buf = np.empty((want, size, size, 3), np.float32)
                    n = lib.vd_read_frames_f32(
                        h, size, stride, want,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if n > 0:
                    chunks.append(buf[:n].copy() if n < want else buf)
                    total += n
                if n < want:
                    break
        finally:
            lib.vd_close(h)
        if not chunks:
            return np.empty((0, size, size, 3), dtype)
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    # python fallback (same cv2 build -> same pixels)
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    frames = []
    idx = 0
    while max_frames is None or len(frames) < max_frames:
        ok, bgr = cap.read()
        if not ok:
            break
        if idx % stride:
            idx += 1
            continue
        idx += 1
        hh, ww = bgr.shape[:2]
        side = min(hh, ww)
        y0, x0 = (hh - side) // 2, (ww - side) // 2
        crop = bgr[y0:y0 + side, x0:x0 + side]
        if side != size:
            crop = cv2.resize(crop, (size, size),
                              interpolation=cv2.INTER_LINEAR)
        rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
        if dtype == np.uint8:
            frames.append(rgb)
        else:
            frames.append(rgb.astype(np.float32) / 256.0)
    cap.release()
    if not frames:
        return np.empty((0, size, size, 3), dtype)
    return np.stack(frames)


def extract_jpegs(path, out_dir, fps: float | None = None,
                  quality: int = 95) -> int:
    """Dump fps-resampled frames as <out_dir>/%04d.jpg (1-based — the
    reference's run_ffmpeg layout, run.py:31-57; fps=None keeps every
    frame). Returns the frame count. Native-only entry; callers that need
    a python fallback go through pipeline.video.extract_frames, which
    delegates here when the native library is available."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    step = 1.0
    if fps is not None:
        native_fps = lib.vd_fps(str(path).encode())
        if native_fps <= 0:
            native_fps = 30.0
        step = max(native_fps / fps, 1.0)
    n = lib.vd_extract_jpegs(str(path).encode(), str(out_dir).encode(),
                             quality, step)
    if n < 0:
        raise FileNotFoundError(f"cannot open video {path}")
    return n
