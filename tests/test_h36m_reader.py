"""H36M npz reader: mono and 4-camera modes against fabricated exports.

Builds tiny VideoPose3D-format npz files (the reference's input format,
H36_dataset.py:302-379) so the real-data code path is exercised hermetically.
"""

import json
import os
import pathlib

import numpy as np
import pytest

from pose3d_tpu.core import cameras as cam_tables
from pose3d_tpu.data import h36m

SUBJECTS = ("S1", "S5")
ACTIONS = ("Walking 1", "Posing")
CAMS = h36m.CAM_SUFFIXES
N_RAW = 32  # raw H36M exports carry 32 joints


@pytest.fixture
def fake_h36m(tmp_path, rng):
    """Write data_2d_h36m.npz + data_3d_h36m{,_mono}.npz under tmp/npz."""
    npz = tmp_path / "npz"
    npz.mkdir()
    frames = {("S1", "Walking 1"): 12, ("S1", "Posing"): 8,
              ("S5", "Walking 1"): 6, ("S5", "Posing"): 10}

    pos3d, pos3d_mono, pos2d = {}, {}, {}
    for s in SUBJECTS:
        pos3d[s], pos3d_mono[s], pos2d[s] = {}, {}, {}
        for a in ACTIONS:
            n = frames[(s, a)]
            world = rng.standard_normal((n, N_RAW, 3)).astype(np.float32)
            pos3d[s][a] = world
            pos3d_mono[s][a] = rng.standard_normal((n, N_RAW, 3)).astype(np.float32)
            pos2d[s][a] = rng.random((n, N_RAW, 2)).astype(np.float32)
            for c in CAMS:
                pos2d[s][a + c] = rng.random((n, N_RAW, 2)).astype(np.float32)

    np.savez(npz / "data_3d_h36m.npz", positions_3d=pos3d)
    np.savez(npz / "data_3d_h36m_mono.npz", positions_3d_mono=pos3d_mono)
    np.savez(npz / "data_2d_h36m.npz", positions_2d=pos2d)
    return tmp_path, frames, pos3d, pos3d_mono, pos2d


class TestReadData:
    def test_mono_mode_shapes_and_values(self, fake_h36m):
        root, frames, _, mono, p2d = fake_h36m
        kp2d, kp3d, paths, cams = h36m.read_data(root, SUBJECTS, "",
                                                 mono_3d_file=True)
        total = sum(frames.values())
        assert kp3d.shape == (total, 17, 3) and kp2d.shape == (total, 17, 2)
        # first frame = S1/"Walking 1"[0] restricted to the 17-joint subset
        sel = list(h36m.H36M_KEYPOINTS_FROM_32)
        np.testing.assert_allclose(kp3d[0], mono["S1"]["Walking 1"][0][sel])
        np.testing.assert_allclose(kp2d[0], p2d["S1"]["Walking 1"][0][sel])

    def test_action_filter_substring(self, fake_h36m):
        root, frames, *_ = fake_h36m
        kp2d, kp3d, _, _ = h36m.read_data(root, SUBJECTS, "Walking")
        assert len(kp3d) == frames[("S1", "Walking 1")] + frames[("S5", "Walking 1")]

    def test_world_to_camera_mode(self, fake_h36m):
        """Non-mono file: 3D transforms into the camera frame using the real
        extrinsics; parity vs the quaternion rotation."""
        import jax.numpy as jnp

        from pose3d_tpu.core.transforms import world_to_camera

        root, frames, world, _, p2d = fake_h36m
        kp2d, kp3d, _, cams = h36m.read_data(
            root, ("S1",), "Posing", mono_3d_file=False, camera_view=True,
        )
        sel = list(h36m.H36M_KEYPOINTS_FROM_32)
        q, t = cam_tables.extrinsics("S1", 0)
        want = np.asarray(world_to_camera(
            jnp.asarray(world["S1"]["Posing"][0][sel]), jnp.asarray(q),
            jnp.asarray(t),
        ))
        np.testing.assert_allclose(kp3d[0], want, atol=1e-5)
        # 2D comes from the per-camera stream
        np.testing.assert_allclose(
            kp2d[0], p2d["S1"]["Posing" + CAMS[0]][0][sel], atol=1e-6)

    def test_all_cameras_mode(self, fake_h36m):
        root, frames, *_ = fake_h36m
        kp2d, kp3d, _, cams = h36m.read_data(
            root, ("S1",), "Posing", mono_3d_file=False, all_cameras=True,
        )
        assert len(kp3d) == frames[("S1", "Posing")] * 4
        assert set(np.unique(cams)) == {0, 1, 2, 3}

    def test_frame_paths_layout(self, fake_h36m):
        root, *_ = fake_h36m
        _, _, paths, _ = h36m.read_data(root, ("S1",), "Posing",
                                        load_frame_paths=True)
        assert paths[0].endswith("S1/outputVideos/Posing.mp4/0001.jpg")

    def test_end_to_end_with_preprocess(self, fake_h36m, tmp_path):
        root, frames, *_ = fake_h36m
        kp2d, kp3d, _, _ = h36m.read_data(root, SUBJECTS, "")
        ds = h36m.preprocess(kp2d, kp3d, tmp_path / "stats", is_train=True,
                             standardize_2d=True, standardize_3d=True)
        assert np.isfinite(ds.kp2d).all() and np.isfinite(ds.kp3d).all()
        np.testing.assert_allclose(ds.kp3d[:, 0], 0.0, atol=1e-6)


class TestRealDataTrainerPath:
    def test_train_lift_on_fake_export(self, fake_h36m, tmp_path):
        """The --data.data_dir code path end-to-end on a fabricated npz."""
        from pose3d_tpu.config import DataConfig, LiftConfig
        from pose3d_tpu.cli.train_lift import train

        root, *_ = fake_h36m
        cfg = LiftConfig(
            n_epochs=1, batch_size=8, run_name="fake_npz",
            log_dir=str(tmp_path / "logs"),
            data=DataConfig(data_dir=str(root), action="",
                            train_subjects=("S1",), test_subjects=("S5",)),
        )
        state = train(cfg)
        assert int(state.step) > 0


class TestVideoPose3DExportSchema:
    def test_reads_genuine_export_schema(self, tmp_path, rng):
        """Format-parity against the exact on-disk schema the VideoPose3D
        prepare scripts emit (and the reference consumes,
        H36_dataset.py:302-313): savez_COMPRESSED, a dict-of-dicts object
        array under the key, float32 payloads, and a 'metadata' entry in
        the 2D file that the reader must ignore."""
        npz = tmp_path / "npz"
        npz.mkdir()
        sel = list(h36m.H36M_KEYPOINTS_FROM_32)
        pos3d = {"S1": {"Walking 1": rng.standard_normal(
            (10, N_RAW, 3)).astype(np.float32)}}
        pos2d = {"S1": {"Walking 1": rng.random(
            (10, N_RAW, 2)).astype(np.float32)}}
        np.savez_compressed(npz / "data_3d_h36m_mono.npz",
                            positions_3d_mono=pos3d)
        np.savez_compressed(
            npz / "data_2d_h36m.npz", positions_2d=pos2d,
            metadata={"layout_name": "h36m", "num_joints": 32,
                      "keypoints_symmetry": [[4, 5, 6, 11, 12, 13],
                                             [1, 2, 3, 14, 15, 16]]})
        kp2d, kp3d, _, _ = h36m.read_data(tmp_path, ("S1",), "")
        assert kp2d.shape == (10, 17, 2) and kp3d.shape == (10, 17, 3)
        np.testing.assert_array_equal(kp3d, pos3d["S1"]["Walking 1"][:, sel])
        np.testing.assert_array_equal(kp2d, pos2d["S1"]["Walking 1"][:, sel])


REAL_H36M = pathlib.Path(os.environ.get("H36M_DATA_DIR", "/root/data/h3.6"))


@pytest.mark.skipif(
    not (REAL_H36M / "npz" / "data_2d_h36m.npz").exists(),
    reason="real H36M export not present (set H36M_DATA_DIR)",
)
class TestRealH36M:
    """Integration on the genuine export: read_data -> preprocess ->
    1 epoch -> MPJPE. Run with
    H36M_DATA_DIR=/path/to/h3.6 pytest tests/test_h36m_reader.py -k Real."""

    def test_one_epoch_mpjpe_on_real_slice(self, tmp_path):
        from pose3d_tpu.config import DataConfig, LiftConfig
        from pose3d_tpu.cli.train_lift import train

        cfg = LiftConfig(
            n_epochs=1, batch_size=64, run_name="real_h36m_smoke",
            log_dir=str(tmp_path / "logs"),
            data=DataConfig(data_dir=str(REAL_H36M), action="Walking",
                            train_subjects=("S1",), test_subjects=("S9",),
                            split_rate=5),
        )
        state = train(cfg)
        assert int(state.step) > 0
        log = tmp_path / "logs" / "runs" / "real_h36m_smoke.jsonl"
        rec = json.loads(log.read_text().splitlines()[-1])
        mpjpe = rec["val_mpjpe"]
        assert np.isfinite(mpjpe) and 0.0 < mpjpe < 1000.0
