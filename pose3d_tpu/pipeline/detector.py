"""2D keypoint detector interface + adapters.

The reference shells out to ``python3 -m openpifpaf.predict`` ONCE PER FRAME
(run.py:134-166) — each call re-initializes the model, which dominates the
pipeline's wall-clock (SURVEY.md section 3.4). The interface here is batched:
a detector consumes a whole frame directory (or array) in one call.

Adapters:
- :class:`OpenPifPafDetector` — subprocess adapter preserving the reference's
  flags (checkpoint shufflenetv2k30, --force-complete-pose,
  --instance-threshold 0.2) but invoked once per *batch* of frames via glob;
  used when openpifpaf is installed (not in this image — kept behind the
  interface so CI runs without it).
- :class:`PoseNet2DDetector` — native in-framework detector: the phase5
  ``PoseNet2D`` model batched on the device (detections in H36M order directly).
- :class:`MockDetector` — deterministic synthetic COCO detections for tests
  and fixtures.

Detection JSON schema (per frame) matches OpenPifPaf's predict output that
``save_to_json`` consumes (run.py:83-99): a list of
{"keypoints": [x,y,conf]*17 flat, "score": float, ...} per person.
"""

from __future__ import annotations

import json
import pathlib
import subprocess

import numpy as np


class Detector2D:
    """Interface: frames -> per-frame person detections (COCO 17-joint)."""

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        """Write one ``<frame>.predictions.json`` per frame (OpenPifPaf
        layout) under ``out_json_dir``."""
        raise NotImplementedError


class OpenPifPafDetector(Detector2D):
    checkpoint = "shufflenetv2k30"
    instance_threshold = 0.2

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        out = pathlib.Path(out_json_dir)
        out.mkdir(parents=True, exist_ok=True)
        frames = sorted(str(p) for p in pathlib.Path(frames_dir).glob("*.jpg"))
        # ONE process for the whole directory (vs per-frame in the reference)
        cmd = [
            "python3", "-m", "openpifpaf.predict", *frames,
            "--checkpoint", self.checkpoint,
            "--force-complete-pose",
            "--instance-threshold", str(self.instance_threshold),
            "--json-output", str(out),
        ]
        subprocess.run(cmd, check=True)


class MockDetector(Detector2D):
    """Deterministic plausible COCO detections (for tests/fixtures)."""

    def __init__(self, seed: int = 0, n_people: int = 1):
        self.seed = seed
        self.n_people = n_people

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        out = pathlib.Path(out_json_dir)
        out.mkdir(parents=True, exist_ok=True)
        frames = sorted(pathlib.Path(frames_dir).glob("*.jpg"))
        rng = np.random.default_rng(self.seed)
        for f in frames:
            people = []
            for p in range(self.n_people):
                kp = np.zeros((17, 3))
                kp[:, 0] = rng.uniform(100, 900, 17)
                kp[:, 1] = rng.uniform(100, 900, 17)
                kp[:, 2] = rng.uniform(0.5, 1.0, 17)
                people.append({
                    "keypoints": kp.flatten().tolist(),
                    "bbox": [100.0, 100.0, 800.0, 800.0],
                    "score": float(rng.uniform(0.3, 0.99)),
                    "category_id": 1,
                })
            with open(out / f"{f.name}.predictions.json", "w") as fh:
                json.dump(people, fh)


class PoseNet2DDetector(Detector2D):
    """Native detector: batched PoseNet2D inference (H36M joint order).

    Output keypoints are emitted in COCO-compatible JSON but already H36M-
    ordered; callers should pass ``already_h36m=True`` downstream.
    """

    def __init__(self, state, image_size: int = 256, batch_size: int = 64):
        self.state = state
        self.image_size = image_size
        self.batch_size = batch_size
        self._infer = None  # jit cached per instance: one compile per run,
        # not per detect_dir call (a fresh inner jit recompiles per video)

    def detect_dir(self, frames_dir, out_json_dir) -> None:
        import jax
        import jax.numpy as jnp

        from pose3d_tpu.pipeline.video import load_frames

        out = pathlib.Path(out_json_dir)
        out.mkdir(parents=True, exist_ok=True)
        files = sorted(pathlib.Path(frames_dir).glob("*.jpg"))
        # uint8 across the host->device boundary (4x less transfer — the
        # dominant detect cost over a narrow link); /256 normalize on
        # device, bit-identical to the f32-host path
        frames = load_frames(frames_dir, size=self.image_size,
                             dtype=np.uint8)

        if self._infer is None:
            @jax.jit
            def infer(params, batch_stats, x_u8):
                x = x_u8.astype(jnp.float32) / 256.0  # H36_dataset.py:131
                return self.state.apply_fn(
                    {"params": params, "batch_stats": batch_stats}, x,
                    train=False,
                )

            self._infer = infer
        infer = self._infer

        # enqueue a bounded window of chunks (async dispatch overlaps
        # transfers with detector compute), draining the oldest result once
        # the window fills — unbounded enqueue keeps every uint8 input
        # buffer in flight at once (a 30k-frame video is ~6 GB of HBM)
        max_inflight = 6
        pending, preds = [], []
        bs = self.batch_size
        for s in range(0, len(frames), bs):
            chunk = frames[s : s + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros_like(chunk[:1]).repeat(pad, 0)])
            pending.append((pad, infer(self.state.params,
                                       self.state.batch_stats,
                                       jnp.asarray(chunk))))
            if len(pending) >= max_inflight:
                p, c = pending.pop(0)
                preds.append(np.asarray(c)[: bs - p])
        preds += [np.asarray(coords)[: bs - pad] for pad, coords in pending]
        coords = np.concatenate(preds).reshape(-1, 17, 2) * 1000.0  # [0,1]->px
        for f, kp in zip(files, coords):
            person = {
                "keypoints": np.concatenate(
                    [kp, np.ones((17, 1))], axis=1
                ).flatten().tolist(),
                "score": 1.0,
                "category_id": 1,
            }
            with open(out / f"{f.name}.predictions.json", "w") as fh:
                json.dump([person], fh)
