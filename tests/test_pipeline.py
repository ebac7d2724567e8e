"""Video pipeline: synthetic video -> detect -> merge -> lift -> npy,
hermetic (mock detector, no ffmpeg/openpifpaf)."""

import json
import pathlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pose3d_tpu.pipeline import keypoints as kp_lib
from pose3d_tpu.pipeline import video as video_lib
from pose3d_tpu.pipeline.detector import MockDetector
from pose3d_tpu.pipeline.run import process_video


@pytest.fixture
def synthetic_video(tmp_path):
    """Write a tiny mp4 + pre-extracted frames."""
    root = tmp_path / "videos"
    raw = root / "raw_videos"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = (rng.random((12, 64, 64, 3)) * 255).astype(np.uint8)
    n = video_lib.write_video(iter(frames), raw / "clip.mp4", fps=10)
    assert n == 12
    return root, "clip.mp4"


class TestVideoIO:
    def test_roundtrip_extract(self, synthetic_video, tmp_path):
        root, video = synthetic_video
        out = tmp_path / "frames"
        n = video_lib.extract_frames(root / "raw_videos" / video, out, fps=100)
        assert n == 12  # fps above native keeps all frames
        files = sorted(out.glob("*.jpg"))
        assert files[0].name == "0001.jpg" and len(files) == 12

    def test_fps_downsample(self, synthetic_video, tmp_path):
        root, video = synthetic_video
        out = tmp_path / "f2"
        n = video_lib.extract_frames(root / "raw_videos" / video, out, fps=5)
        assert n == 6

    def test_load_frames_normalized(self, synthetic_video, tmp_path):
        root, video = synthetic_video
        out = tmp_path / "f3"
        video_lib.extract_frames(root / "raw_videos" / video, out, fps=100)
        frames = video_lib.load_frames(out, size=32)
        assert frames.shape == (12, 32, 32, 3)
        assert frames.dtype == np.float32
        assert 0 <= frames.min() and frames.max() < 1.0  # /256 convention

    def test_load_frames_uint8_bit_identical(self, synthetic_video,
                                             tmp_path):
        """uint8 loading + on-device-style /256 normalize must equal the
        f32 host path exactly (the detector's 4x-smaller transfer relies
        on this)."""
        root, video = synthetic_video
        out = tmp_path / "f4"
        video_lib.extract_frames(root / "raw_videos" / video, out, fps=100)
        f32 = video_lib.load_frames(out, size=32)
        u8 = video_lib.load_frames(out, size=32, dtype=np.uint8)
        assert u8.dtype == np.uint8
        np.testing.assert_array_equal(u8.astype(np.float32) / 256.0, f32)


class TestDetectMerge:
    def test_mock_detector_schema(self, synthetic_video, tmp_path):
        root, video = synthetic_video
        frames = tmp_path / "fr"
        video_lib.extract_frames(root / "raw_videos" / video, frames, fps=100)
        jsons = tmp_path / "jsons"
        MockDetector(n_people=3).detect_dir(frames, jsons)
        files = list(jsons.glob("*.predictions.json"))
        assert len(files) == 12
        people = json.loads(files[0].read_text())
        assert len(people) == 3
        assert len(people[0]["keypoints"]) == 51

    def test_merge_picks_max_score(self, tmp_path):
        jsons = tmp_path / "j"
        jsons.mkdir()
        people = [
            {"keypoints": (np.ones((17, 3)) * 1).flatten().tolist(), "score": 0.2},
            {"keypoints": (np.ones((17, 3)) * 2).flatten().tolist(), "score": 0.9},
        ]
        (jsons / "0001.jpg.predictions.json").write_text(json.dumps(people))
        records = kp_lib.merge_detections(jsons)
        assert len(records) == 1
        assert records[0]["score"] == 0.9
        kp = np.asarray(records[0]["keypoints"])
        assert kp.shape == (17, 3)
        # all-2 input: midpoint synthesis keeps value 2 everywhere
        np.testing.assert_allclose(kp[:, :2], 2.0)
        np.testing.assert_allclose(kp[:, 2], 2.0)  # conf passes through

    def test_empty_frame_zero_record(self, tmp_path):
        jsons = tmp_path / "j"
        jsons.mkdir()
        (jsons / "0001.jpg.predictions.json").write_text("[]")
        records = kp_lib.merge_detections(jsons)
        np.testing.assert_allclose(np.asarray(records[0]["keypoints"]), 0.0)
        assert records[0]["score"] == 0.0

    def test_reference_json_schema(self, tmp_path):
        """Consolidated JSON: list of {image_id, category_id, keypoints,
        score} (run.py:99)."""
        jsons = tmp_path / "j"
        jsons.mkdir()
        (jsons / "0001.jpg.predictions.json").write_text(json.dumps(
            [{"keypoints": np.zeros(51).tolist(), "score": 0.7}]
        ))
        out = tmp_path / "final.json"
        kp_lib.save_to_json(jsons, out)
        rec = json.loads(out.read_text())[0]
        assert set(rec) == {"image_id", "category_id", "keypoints", "score"}
        assert rec["category_id"] == 1

    def test_mb_npy_roundtrip(self, tmp_path, rng):
        poses = rng.random((40, 17, 3)).astype(np.float32)
        kp_lib.save_mb_npy(poses, tmp_path / "v.npy")
        loaded = kp_lib.load_mb_npy(tmp_path / "v.npy")
        np.testing.assert_array_equal(loaded, poses)


class TestEndToEnd:
    def test_full_pipeline_with_lifting(self, synthetic_video):
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.models.temporal import TemporalLifter
        from pose3d_tpu.train.state import create_train_state

        root, video = synthetic_video
        lifter = TemporalLifter(clip_len=8, hidden=32, n_blocks=1, heads=2)
        state = create_train_state(
            lifter, jax.random.key(0), jnp.zeros((1, 8, 17, 2)), lr=1e-3
        )
        poses = process_video(video, root, MockDetector(), lifter,
                              state.params, fps=100)
        assert poses.shape == (12, 17, 3)
        assert (root / "final_json_outputs" / f"{video}.json").exists()
        assert (root / "MB_npy" / f"{video}.npy").exists()
        loaded = kp_lib.load_mb_npy(root / "MB_npy" / f"{video}.npy")
        np.testing.assert_allclose(loaded, poses, atol=1e-6)


class TestNativeDetector:
    @pytest.mark.slow
    def test_posenet2d_detector_end_to_end(self, synthetic_video, tmp_path):
        """The native detector branch: frames -> H36M-ordered detections
        -> merged JSON with already_h36m semantics."""
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.models.heads import PoseNet2D
        from pose3d_tpu.pipeline.detector import PoseNet2DDetector
        from pose3d_tpu.train.state import create_train_state

        root, video = synthetic_video
        frames_dir = tmp_path / "fr"
        video_lib.extract_frames(root / "raw_videos" / video, frames_dir,
                                 fps=100)
        model = PoseNet2D(architecture="resnet18")
        state = create_train_state(
            model, jax.random.key(0), jnp.zeros((1, 64, 64, 3)), lr=1e-3,
        )
        det = PoseNet2DDetector(state, image_size=64, batch_size=4)
        jsons = tmp_path / "jsons"
        det.detect_dir(frames_dir, jsons)
        assert len(list(jsons.glob("*.predictions.json"))) == 12

        records = kp_lib.save_to_json(jsons, tmp_path / "final.json",
                                      already_h36m=True)
        kp = np.asarray(records[0]["keypoints"])
        assert kp.shape == (17, 3)
        # coords came out of a [0,1] soft-argmax scaled x1000 px
        assert 0 <= kp[:, :2].min() and kp[:, :2].max() <= 1000
