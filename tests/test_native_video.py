"""Native C++ video decoder vs the python cv2 path (same codec build ->
bit-identical pixels). Skips gracefully if the library can't build."""

import numpy as np
import pytest

from pose3d_tpu.data import native_video
from pose3d_tpu.data.native_build import ensure_built

# build is explicit now (no compiler side effects at decode time);
# the video library additionally needs OpenCV C++ and may legitimately be
# absent — the skipif below handles that.
try:
    ensure_built()
except RuntimeError:
    pass


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    import cv2

    path = tmp_path_factory.mktemp("vid") / "clip.mp4"
    rng = np.random.default_rng(0)
    w, h, n = 96, 64, 25
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, (w, h))
    # smooth gradients survive lossy encoding closely enough for parity
    for i in range(n):
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        frame = np.stack([
            (xx * 2 + i * 5) % 256, (yy * 3) % 256, ((xx + yy) + i * 7) % 256,
        ], axis=-1).astype(np.uint8)
        writer.write(frame)
    writer.release()
    return path


needs_native = pytest.mark.skipif(
    not native_video.native_available(), reason="native video lib unavailable"
)


@needs_native
class TestNativeVideoDecode:
    def test_matches_python_path_bitexact(self, video_file, monkeypatch):
        native = native_video.read_video_frames(video_file, size=48)
        # force the python fallback
        monkeypatch.setattr(native_video, "_load_library", lambda: None)
        python = native_video.read_video_frames(video_file, size=48)
        assert native.shape == python.shape == (25, 48, 48, 3)
        np.testing.assert_array_equal(native, python)

    def test_f32_convention(self, video_file):
        u8 = native_video.read_video_frames(video_file, size=32,
                                            dtype=np.uint8)
        f32 = native_video.read_video_frames(video_file, size=32,
                                             dtype=np.float32)
        assert f32.dtype == np.float32
        np.testing.assert_allclose(f32, u8.astype(np.float32) / 256.0,
                                   atol=1e-6)

    def test_stride_and_max_frames(self, video_file):
        strided = native_video.read_video_frames(video_file, size=32,
                                                 stride=3)
        assert strided.shape[0] == 9  # ceil(25/3)
        capped = native_video.read_video_frames(video_file, size=32,
                                                max_frames=4)
        assert capped.shape[0] == 4

    def test_extract_jpegs_reference_layout(self, video_file, tmp_path):
        n = native_video.extract_jpegs(video_file, tmp_path / "frames")
        assert n == 25
        names = sorted(p.name for p in (tmp_path / "frames").glob("*.jpg"))
        assert names[0] == "0001.jpg" and names[-1] == "0025.jpg"

    def test_extract_jpegs_fps_matches_python_selection(self, video_file,
                                                        tmp_path):
        """The fractional fps-resampling keep rule must pick the same frames
        as pipeline.video.iter_frames."""
        from pose3d_tpu.pipeline.video import iter_frames

        n = native_video.extract_jpegs(video_file, tmp_path / "f", fps=4.0)
        python_n = sum(1 for _ in iter_frames(video_file, fps=4.0))
        assert n == python_n

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            native_video.read_video_frames(tmp_path / "nope.mp4")

    def test_chunked_reads_with_stride(self, tmp_path_factory):
        """>256 frames forces multiple internal read chunks; the stride
        phase must carry across chunk boundaries (Decoder-held counter)."""
        import cv2

        path = tmp_path_factory.mktemp("vid2") / "long.mp4"
        w, h, n = 64, 48, 300
        writer = cv2.VideoWriter(str(path),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                                 (w, h))
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        for i in range(n):
            writer.write(np.stack([(xx + i) % 256, (yy * 2) % 256,
                                   (xx + yy + 2 * i) % 256],
                                  -1).astype(np.uint8))
        writer.release()
        native = native_video.read_video_frames(path, size=32, stride=7)
        assert native.shape[0] == 43  # ceil(300/7)
        import unittest.mock

        with unittest.mock.patch.object(native_video, "_load_library",
                                        lambda: None):
            python = native_video.read_video_frames(path, size=32, stride=7)
        np.testing.assert_array_equal(native, python)


def test_stream_matches_batch_reader(video_file):
    """stream_video_frames chunks concatenate to exactly read_video_frames
    — on whichever path is active (native or cv2 fallback)."""
    batch = native_video.read_video_frames(video_file, size=48)
    chunks = list(native_video.stream_video_frames(video_file, size=48,
                                                   chunk=7))
    assert all(len(c) == 7 for c in chunks[:-1])
    assert len(chunks[-1]) == 25 - 7 * (len(chunks) - 1)
    np.testing.assert_array_equal(np.concatenate(chunks), batch)


def test_stream_fallback_matches_native(video_file, monkeypatch):
    """The python-fallback stream yields the same pixels as the active
    path (bit-identical codec/resize contract)."""
    active = np.concatenate(list(
        native_video.stream_video_frames(video_file, size=32, chunk=6)))
    monkeypatch.setattr(native_video, "_load_library", lambda: None)
    fallback = np.concatenate(list(
        native_video.stream_video_frames(video_file, size=32, chunk=6)))
    np.testing.assert_array_equal(active, fallback)


def test_pipeline_extract_frames_uses_native(video_file, tmp_path):
    """pipeline.video.extract_frames must produce the reference layout
    through whichever path is active."""
    from pose3d_tpu.pipeline.video import extract_frames

    n = extract_frames(video_file, tmp_path / "out", fps=5.0)
    files = sorted((tmp_path / "out").glob("*.jpg"))
    assert len(files) == n > 0
    assert files[0].name == "0001.jpg"
