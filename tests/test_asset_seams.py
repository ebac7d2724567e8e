"""Coverage for the two external-asset seams without the real assets:

1. ``load_smpl`` on a fabricated pickle in the reference's exact format
   (SMPL.py:84-147 key set, scipy-sparse J_regressor) — the licensed
   basicModel pkl is absent in this environment, so the pickle/sparse
   handling path was previously write-only code.
2. ``OpenPifPafDetector`` against a fake ``python3 -m openpifpaf.predict``
   that honors the reference's CLI contract (run.py:159-166): per-input-frame
   ``<frame>.predictions.json`` files written into ``--json-output <dir>``.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest


class TestLoadSmplPickle:
    @pytest.fixture()
    def fake_pkl(self, tmp_path):
        """Reference-format SMPL pickle built from the synthetic body, so the
        loaded result can be checked against known buffers."""
        scipy_sparse = pytest.importorskip("scipy.sparse")
        from pose3d_tpu.models.smpl import synthetic_model

        m = synthetic_model(n_vertices=120, seed=3)
        v = m.v_template.shape[0]
        # the real pkl stores posedirs as (V, 3, 207) — load_smpl transposes
        posedirs_v3p = np.ascontiguousarray(
            m.posedirs.T.reshape(v, 3, 207)
        ).astype(np.float64)
        data = {
            "v_template": m.v_template.astype(np.float64),
            "shapedirs": m.shapedirs.astype(np.float64),
            "posedirs": posedirs_v3p,
            # the real asset's J_regressor is a scipy sparse matrix
            "J_regressor": scipy_sparse.csc_matrix(m.j_regressor),
            "weights": m.lbs_weights.astype(np.float64),
            "kintree_table": np.stack(
                [np.concatenate([[0], m.parents[1:24]]), np.arange(24)]
            ),
            "f": np.zeros((4, 3), np.int64),  # faces, unused here
            # real pkls carry extra keys the loader must ignore
            "J": np.zeros((24, 3)),
            "bs_style": "lbs",
        }
        p = tmp_path / "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"
        with open(p, "wb") as fh:
            pickle.dump(data, fh)
        h36m = tmp_path / "J_regressor_h36m.npy"
        np.save(h36m, m.j_regressor_h36m.astype(np.float64))
        return p, h36m, m

    def test_load_smpl_roundtrip(self, fake_pkl):
        from pose3d_tpu.models.smpl import load_smpl

        pkl, h36m, m = fake_pkl
        loaded = load_smpl(pkl, h36m)
        np.testing.assert_allclose(loaded.v_template, m.v_template, atol=1e-6)
        np.testing.assert_allclose(loaded.shapedirs, m.shapedirs, atol=1e-6)
        np.testing.assert_allclose(loaded.posedirs, m.posedirs, atol=1e-6)
        np.testing.assert_allclose(
            loaded.j_regressor, m.j_regressor, atol=1e-6
        )
        np.testing.assert_allclose(
            loaded.j_regressor_h36m, m.j_regressor_h36m, atol=1e-6
        )
        np.testing.assert_allclose(
            loaded.lbs_weights, m.lbs_weights, atol=1e-6
        )
        for arr in (loaded.v_template, loaded.shapedirs, loaded.posedirs,
                    loaded.j_regressor, loaded.lbs_weights):
            assert arr.dtype == np.float32

    def test_loaded_model_runs_fk(self, fake_pkl):
        """The pickle-loaded body must drive the full LBS path."""
        from pose3d_tpu.models.smpl import lbs, load_smpl

        pkl, h36m, _ = fake_pkl
        model = load_smpl(pkl, h36m)
        betas = np.zeros((2, 10), np.float32)
        pose = np.zeros((2, 72), np.float32)
        verts, joints, rots, jh36m = lbs(model, betas, pose)
        assert verts.shape == (2, 120, 3)
        assert joints.shape == (2, 24, 3)
        assert np.isfinite(np.asarray(verts)).all()


FAKE_PREDICT = textwrap.dedent(
    """
    import argparse, json, pathlib, sys

    p = argparse.ArgumentParser()
    p.add_argument("images", nargs="+")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--force-complete-pose", action="store_true")
    p.add_argument("--instance-threshold", type=float, required=True)
    p.add_argument("--json-output", required=True)
    args = p.parse_args()

    assert args.checkpoint == "shufflenetv2k30", args.checkpoint
    assert args.force_complete_pose
    assert abs(args.instance_threshold - 0.2) < 1e-9

    out = pathlib.Path(args.json_output)
    for img in args.images:
        name = pathlib.Path(img).name
        person = {
            "keypoints": [float(i) for i in range(51)],
            "bbox": [0.0, 0.0, 10.0, 10.0],
            "score": 0.9,
            "category_id": 1,
        }
        with open(out / (name + ".predictions.json"), "w") as fh:
            json.dump([person], fh)
    """
)


class TestOpenPifPafSubprocessContract:
    @pytest.fixture()
    def fake_openpifpaf(self, tmp_path, monkeypatch):
        """Install a fake openpifpaf package reachable by the subprocess."""
        pkg = tmp_path / "fakesite" / "openpifpaf"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "predict.py").write_text(FAKE_PREDICT)
        # Prepend to PYTHONPATH for the child process; keep the existing
        # entries (the environment may rely on them).
        old = os.environ.get("PYTHONPATH", "")
        monkeypatch.setenv(
            "PYTHONPATH", os.pathsep.join([str(pkg.parent), old])
        )
        return pkg.parent

    def test_detector_invokes_reference_cli_contract(
        self, tmp_path, fake_openpifpaf
    ):
        from pose3d_tpu.pipeline.detector import OpenPifPafDetector
        from pose3d_tpu.pipeline.keypoints import merge_detections

        frames = tmp_path / "frames"
        frames.mkdir()
        for i in range(1, 4):
            (frames / f"{i:04d}.jpg").write_bytes(b"\xff\xd8\xff\xd9")

        out = tmp_path / "jsons_force"
        OpenPifPafDetector().detect_dir(frames, out)

        files = sorted(p.name for p in out.glob("*.predictions.json"))
        assert files == [
            "0001.jpg.predictions.json",
            "0002.jpg.predictions.json",
            "0003.jpg.predictions.json",
        ]
        # and the outputs feed the merge step (reference save_to_json path)
        records = merge_detections(out)
        assert len(records) == 3
        assert records[0]["image_id"] == "0001.jpg.predictions.json"
        assert np.asarray(records[0]["keypoints"]).shape == (17, 3)
