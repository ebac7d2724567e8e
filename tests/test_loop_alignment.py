"""Pin the loop-trainer frame<->kp2d<->kp3d index alignment.

cli/train_loop.py loads frames+kp3d through ``load_image_split`` (which
subsamples inside ``h36m.preprocess``) and the 2D targets through a SECOND
``h36m.read_data`` call followed by ``kp2d[::split_rate][:len(frames)]`` —
correct only while both loaders enumerate subjects/actions/frames in the
identical order with identical subsampling (reference contract: train_5.py
:95-99 feeds all three from ONE dataset object). This test fabricates an
on-disk image+npz tree whose jpg pixels, 2D values and 3D values all encode
the (action, frame) identity, runs the REAL ``load_frames_split``, and
asserts the three streams agree index by index — so a reordering in either
loader can no longer silently mistrain the 2D head.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pose3d_tpu.cli.train_loop import load_frames_split  # noqa: E402
from pose3d_tpu.config import DataConfig, LoopConfig  # noqa: E402
from pose3d_tpu.data import h36m  # noqa: E402

N_RAW = 32
ACTIONS = ("Walking 1", "Walking 2")  # both match the "Walking" filter
FRAMES = {("S1", "Walking 1"): 9, ("S1", "Walking 2"): 7,
          ("S11", "Walking 1"): 5, ("S11", "Walking 2"): 6}
SPLIT_RATE = 2

ROOT_IDX = h36m.H36M_KEYPOINTS_FROM_32[0]


def _code(action_idx: int, frame_idx: int) -> int:
    """Identity code for (action, frame), fits uint8 with jpeg headroom."""
    return 40 + action_idx * 100 + frame_idx * 8


@pytest.fixture
def fake_tree(tmp_path, rng):
    npz = tmp_path / "npz"
    npz.mkdir()
    pos3d_mono, pos2d = {}, {}
    # per-joint pattern that survives root-centring: joint j offset j along x
    pattern = np.zeros((N_RAW, 3), np.float32)
    pattern[:, 0] = np.arange(N_RAW)
    for s in ("S1", "S11"):
        pos3d_mono[s], pos2d[s] = {}, {}
        for ai, a in enumerate(ACTIONS):
            n = FRAMES[(s, a)]
            codes = np.array([_code(ai, i) for i in range(n)], np.float32)
            p3 = np.zeros((n, N_RAW, 3), np.float32)
            p3 += pattern * codes[:, None, None] * 1e-3
            p3[:, :, 2] += 5.0  # arbitrary root offset, removed by centring
            pos3d_mono[s][a] = p3
            p2 = np.zeros((n, N_RAW, 2), np.float32)
            p2 += codes[:, None, None] * 1e-3
            pos2d[s][a] = p2
            for c in h36m.CAM_SUFFIXES:
                pos2d[s][a + c] = p2.copy()
            # frame jpgs: uniform gray = the identity code
            d = tmp_path / "videos" / s / "outputVideos" / f"{a}.mp4"
            d.mkdir(parents=True)
            for i in range(n):
                img = np.full((48, 64, 3), _code(ai, i), np.uint8)
                cv2.imwrite(str(d / f"{i + 1:04d}.jpg"), img,
                            [cv2.IMWRITE_JPEG_QUALITY, 98])
    np.savez(npz / "data_3d_h36m_mono.npz", positions_3d_mono=pos3d_mono)
    np.savez(npz / "data_2d_h36m.npz", positions_2d=pos2d)
    return tmp_path


class TestLoopTargetAlignment:
    @pytest.mark.parametrize("is_train", [True, False])
    def test_frames_kp2d_kp3d_agree_indexwise(self, fake_tree, is_train):
        cfg = LoopConfig(
            image_size=32,
            data=DataConfig(data_dir=str(fake_tree), action="Walking",
                            split_rate=SPLIT_RATE, standardize_3d=False),
        )
        frames, kp2d, kp3d = load_frames_split(cfg, is_train)
        subject = "S1" if is_train else "S11"
        # split_rate strides the FLATTENED subject/action concatenation
        # (H36_dataset applies it to the already-joined arrays)
        total = sum(FRAMES[(subject, a)] for a in ACTIONS)
        expected_n = len(range(0, total, SPLIT_RATE))
        assert len(frames) == len(kp2d) == len(kp3d) == expected_n

        sel = list(h36m.H36M_KEYPOINTS_FROM_32)
        for j in range(len(frames)):
            code_img = float(np.asarray(frames[j], np.float32).mean())
            code_2d = float(kp2d[j, 0, 0]) * 1e3
            # kp3d is root-centred: joint k keeps (sel[k]-sel[0])*code*1e-3
            scale = sel[1] - sel[0]
            code_3d = float(kp3d[j, 1, 0]) / scale * 1e3
            assert abs(code_2d - code_3d) < 1e-2, (
                f"index {j}: kp2d encodes {code_2d:.1f}, "
                f"kp3d encodes {code_3d:.1f} — loaders disagree"
            )
            assert abs(code_img - code_2d) < 3.0, (
                f"index {j}: frame pixels encode {code_img:.1f}, "
                f"kp2d encodes {code_2d:.1f} — frame stream misaligned"
            )
