"""Benchmark: the six workloads of the pose stack on one GPU.

Cells, in roadmap order (each times the path the package runs for users):
  lifting_infer  — ``LifterService``'s compiled forward of the bf16
                   ``JointTransformerLifter``, B=8192 (the headline)
  flip_lift      — flip-consistency lifting: {identity, flip} as one 2x
                   batch through the same lifter, B=4096 (train_5.py:153-168)
  direct_train   — R50 + 64^3 volumetric soft-argmax train step, B=64 bf16
  temporal_train — 243-frame, 5-block temporal transformer train step, B=8
  temporal_infer — the same model's forward as ``pipeline.lift`` runs it,
                   B=16 clips
  e2e_video      — video -> 2D detector -> temporal lift, wall clock

stdout: exactly ONE JSON line — the headline lifting metric, with every
cell under "extra". A cell that fails records its error and the others
still run. Every cell names the platform, ``device_kind`` and device count.
Human-readable logs go to stderr.

Timing: the first call compiles (reported as ``compile_s``); then ``iters``
calls are enqueued and fenced by ``block_until_ready``, ``repeats`` times.
The median per-call time is the cell's number, with the min and max beside
it. FLOPs are counted from the model's shapes (``*_flops`` below: the
matmuls and attention products a call needs, 3x the forward for a train
step, nothing for recomputation) and divided by the device's published
bf16 peak (``PEAKS``). XLA's own cost analysis is not used: on the GPU it
leaves out the matmuls it hands to cuBLAS.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

# Published dense peaks per device kind. Source: NVIDIA H100 Tensor Core
# GPU data sheet (SXM5): 989 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3,
# at the full 700 W power limit. A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12,
                              "source": "NVIDIA H100 data sheet, SXM5"},
}

REPEATS = 5


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       "add them to bench.PEAKS with their source") from None


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def measure(call, iters: int, repeats: int = REPEATS) -> dict:
    """Time ``call()`` (one unit of work, returning device arrays): the
    first call compiles; then ``iters`` calls per repeat, fenced once."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    compile_s = time.perf_counter() - t0
    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = call()
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / iters)
    return {"compile_s": round(compile_s, 2),
            "ms": statistics.median(per) * 1e3,
            "ms_min_max": [min(per) * 1e3, max(per) * 1e3]}


def block_flops(tokens: int, seq: int, dim: int, mlp_ratio: int = 4) -> float:
    """One pre-LN attention + MLP sub-block over ``tokens`` tokens in
    sequences of ``seq``: qkv, output and MLP matmuls (2*(3+1+2*ratio)*d^2
    per token) plus scores and weighted values (4*seq*d per token)."""
    return tokens * (2.0 * (4 + 2 * mlp_ratio) * dim * dim + 4.0 * seq * dim)


def lifter_flops(frames: int, joints: int = 17, dim: int = 256,
                 n_blocks: int = 2, in_dim: int = 2, out_dim: int = 3):
    """JointTransformerLifter forward: embed, blocks over joint tokens,
    per-token MLP head."""
    tokens = frames * joints
    return (2.0 * tokens * in_dim * dim
            + n_blocks * block_flops(tokens, joints, dim)
            + 2.0 * tokens * (dim * dim // 2 + dim // 2 * out_dim))


def temporal_flops(clips: int, t: int = 243, joints: int = 17,
                   dim: int = 256, n_blocks: int = 5, train: bool = False):
    """TemporalLifter forward (x3 for a train step): each block attends
    over joints within frames, then over frames per joint."""
    tokens = clips * t * joints
    fwd = (2.0 * tokens * 2 * dim
           + n_blocks * (block_flops(tokens, joints, dim)
                         + block_flops(tokens, t, dim))
           + 2.0 * tokens * (dim * dim // 2 + dim // 2 * 3))
    return 3.0 * fwd if train else fwd


def rate_fields(items: int, timing: dict, flops: float | None,
                peak: float) -> dict:
    out = {"items_per_s": items / (timing["ms"] * 1e-3), **timing}
    if flops:
        tflops = flops / (timing["ms"] * 1e-3) / 1e12
        out.update(tflops=tflops, share_of_bf16_peak=tflops * 1e12 / peak)
    return out


def _random_params(model, shape, seed=0):
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda k: model.init(k, jnp.zeros(shape)))(
        jax.random.key(seed))


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def cell_lifting_infer(peak):
    import jax.numpy as jnp

    from pose3d_tpu.models.lifters import JointTransformerLifter
    from pose3d_tpu.serving import LifterService

    b = 8192
    model = JointTransformerLifter(dtype=jnp.bfloat16)
    params = _random_params(model, (1, 17, 2))["params"]
    svc = LifterService(model, params, max_batch=b)
    x = jnp.asarray(np.random.default_rng(0).random((b, 17, 2), np.float32))
    timing = measure(lambda: svc._fn(x), iters=50)
    return {"config": "JointTransformerLifter bf16, B=8192 (top serving "
                      "bucket), device-resident input",
            **rate_fields(b, timing, lifter_flops(b), peak)}


def cell_flip_lift(peak):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.core.transforms import flip_pose
    from pose3d_tpu.models.lifters import JointTransformerLifter

    b = 4096
    model = JointTransformerLifter(dtype=jnp.bfloat16)
    params = _random_params(model, (1, 17, 2))["params"]

    @jax.jit
    def flip_lift(p, kp):
        out = model.apply({"params": p}, jnp.concatenate([kp, flip_pose(kp)]))
        return (out[:b] + flip_pose(out[b:])) / 2.0

    x = jnp.asarray(np.random.default_rng(0).random((b, 17, 2), np.float32))
    timing = measure(lambda: flip_lift(params, x), iters=50)
    return {"config": "flip-consistency 2x batch, JointTransformerLifter "
                      "bf16, B=4096",
            **rate_fields(b, timing, lifter_flops(2 * b), peak)}


def _train_cell(state, step, batches, frames_per_batch, flops, iters, peak):
    """Time a donated train step; the state threads through the calls."""
    import jax

    box = [state]
    keys = jax.random.split(jax.random.key(1), len(batches))

    def call():
        i = call.n % len(batches)
        call.n += 1
        box[0], m = step(box[0], *batches[i], keys[i])
        return m["loss"]

    call.n = 0
    timing = measure(call, iters=iters)
    loss = float(call())
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    return {**rate_fields(frames_per_batch, timing, flops, peak),
            "final_loss": loss}


def cell_direct_train(peak):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet3D
    from pose3d_tpu.train.image_steps import make_direct_train_step
    from pose3d_tpu.train.state import create_train_state

    b = 64
    model = PoseNet3D(return_heatmap=False, dtype=jnp.bfloat16)
    state = create_train_state(model, jax.random.key(0),
                               jnp.zeros((2, 256, 256, 3)), lr=1e-3)
    rng = np.random.default_rng(0)
    batches = [(jnp.asarray(rng.integers(0, 256, (b, 256, 256, 3), np.uint8)),
                jnp.asarray(rng.random((b, 17, 3), np.float32) - 0.5))
               for _ in range(2)]
    return {"config": "R50 + 64^3 soft-argmax train step, B=64 bf16",
            **_train_cell(state, make_direct_train_step(), batches, b, None,
                          10, peak)}


def cell_temporal_train(peak):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.train.state import create_train_state
    from pose3d_tpu.train.steps import make_lifter_train_step

    b = 8
    model = TemporalLifter(dtype=jnp.bfloat16)
    t = model.clip_len
    state = create_train_state(model, jax.random.key(0),
                               jnp.zeros((2, t, 17, 2)), lr=1e-3)
    rng = np.random.default_rng(0)
    batches = [(jnp.asarray(rng.random((b, t, 17, 2), np.float32)),
                jnp.asarray(rng.random((b, t, 17, 3), np.float32) - 0.5))
               for _ in range(2)]
    return {"config": "243-frame 5-block temporal transformer train step, "
                      "B=8 bf16",
            **_train_cell(state, make_lifter_train_step(), batches, b * t,
                          temporal_flops(b, t, train=True), 10, peak)}


def cell_temporal_infer(peak):
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.pipeline.lift import _infer

    b = 16
    model = TemporalLifter(dtype=jnp.bfloat16)
    t = model.clip_len
    params = _random_params(model, (1, t, 17, 2))["params"]
    x = jnp.asarray(np.random.default_rng(0).random((b, t, 17, 2),
                                                    np.float32))
    infer = _infer()
    timing = measure(lambda: infer(model, params, x), iters=20)
    return {"config": "243-frame temporal transformer forward, B=16 clips "
                      "bf16 (pipeline.lift's compiled call)",
            **rate_fields(b * t, timing, temporal_flops(b, t), peak)}


def cell_e2e_video(peak):
    """Video file -> 2D detector (PoseNet2D, random weights) -> temporal
    lift, wall clock including decode and host<->device copies."""
    del peak
    import pathlib
    import tempfile

    import cv2
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.data.native_video import stream_video_frames
    from pose3d_tpu.models.heads import PoseNet2D
    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.pipeline.lift import lift_sequence

    n, chunk = 512, 64
    video = pathlib.Path(tempfile.mkdtemp()) / "bench.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (640, 480))
    xx, yy = np.meshgrid(np.arange(640), np.arange(480))
    for i in range(n):
        writer.write(np.stack([(xx * 2 + i * 3) % 256, (yy * 3 + i) % 256,
                               (xx + yy + i * 5) % 256], -1).astype(np.uint8))
    writer.release()

    det = PoseNet2D(dtype=jnp.bfloat16)
    det_vars = _random_params(det, (1, 256, 256, 3))
    lifter = TemporalLifter(dtype=jnp.bfloat16)
    lifter_params = _random_params(lifter, (1, 243, 17, 2), seed=1)["params"]

    @jax.jit
    def detect(variables, frames_u8):
        x = frames_u8.astype(jnp.float32) / 256.0  # H36_dataset.py:131
        return det.apply(variables, x, train=False).reshape(-1, 17, 2)

    def run():
        pending = []
        for frames in stream_video_frames(video, size=256, chunk=chunk):
            pad = chunk - len(frames)
            frames = np.concatenate(
                [frames, np.zeros((pad, 256, 256, 3), np.uint8)])
            pending.append((detect(det_vars, jnp.asarray(frames)),
                            chunk - pad))
        kp2d = np.concatenate([np.asarray(p)[:m] for p, m in pending])
        return lift_sequence(lifter_params, lifter, kp2d * 1000.0)

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
    assert out.shape == (n, 17, 3) and np.isfinite(out).all()
    wall = statistics.median(walls)
    return {"config": f"640x480 mp4, {n} frames -> PoseNet2D R50 bf16 "
                      "(random weights) -> temporal lift bf16",
            "video_frames_per_s": n / wall, "wall_ms": wall * 1e3,
            "wall_ms_min_max": [min(walls) * 1e3, max(walls) * 1e3],
            "compile_s": round(compile_s, 2)}


CELLS = [
    ("lifting_infer", cell_lifting_infer),
    ("flip_lift", cell_flip_lift),
    ("direct_train", cell_direct_train),
    ("temporal_train", cell_temporal_train),
    ("temporal_infer", cell_temporal_infer),
    ("e2e_video", cell_e2e_video),
]


def torch_cpu_lifting_rate() -> float:
    """Torch-CPU throughput of the same lifter architecture: a clean-room
    module with the reference MyViT's hyperparameters
    (baselineModel.py:312-362), B=512, best of 3. Raises ImportError
    without torch."""
    import torch

    from pose3d_tpu.models.lifters import sinusoidal_positional_embeddings

    h, heads, nn = 256, 4, torch.nn

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1, self.ln_attn, self.ln2 = (nn.LayerNorm(h)
                                                for _ in range(3))
            self.qkv = nn.Linear(h, 3 * h, bias=False)
            self.proj = nn.Linear(h, h, bias=False)
            self.fc1, self.fc2 = nn.Linear(h, 4 * h), nn.Linear(4 * h, h)

        def forward(self, x):
            y = self.ln_attn(self.ln1(x))  # the reference's double LN
            b, n, _ = y.shape
            q, k, v = (t.reshape(b, n, heads, h // heads).transpose(1, 2)
                       for t in self.qkv(y).chunk(3, dim=-1))
            a = torch.softmax(q @ k.transpose(-1, -2) * (h // heads) ** -0.5,
                              dim=-1)
            x = x + self.proj((a @ v).transpose(1, 2).reshape(b, n, h))
            return x + self.fc2(nn.functional.gelu(self.fc1(self.ln2(x))))

    embed, head1, head2 = nn.Linear(2, h), nn.Linear(h, h // 2), nn.Linear(
        h // 2, 3)
    blocks = [Block().eval() for _ in range(2)]
    pe = torch.from_numpy(sinusoidal_positional_embeddings(17, h))
    x = torch.rand(512, 17, 2)

    def forward():
        y = embed(x) + pe
        for blk in blocks:
            y = blk(y)
        return head2(torch.relu(head1(y)))

    best = float("inf")
    with torch.no_grad():
        forward()
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(8):
                forward()
            best = min(best, time.perf_counter() - t0)
    return 512 * 8 / best


def main():
    import jax

    from pose3d_tpu.utils.runtime import (
        device_info,
        enable_compile_cache,
        nvidia_smi,
    )

    cache = enable_compile_cache()
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"bench: JAX runs on {info['platform']!r}, not a "
                         "GPU; nothing to measure")
    peaks = peaks_for(info["kind"])
    setup = {"device": info, "nvidia_smi": nvidia_smi(), "peaks": peaks,
             "xla_flags": os.environ.get("XLA_FLAGS"), "jax": jax.__version__,
             "compile_cache": cache}
    _log(f"bench setup: {setup}")

    extra = {"setup": setup}
    for name, cell in CELLS:
        t0 = time.perf_counter()
        try:
            rec = cell(peaks["bf16_flops"])
        except Exception as e:  # noqa: BLE001 — one cell must not stop the rest
            rec = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        rec.update(device=info, cell_s=round(time.perf_counter() - t0, 1))
        _log(f"{name}: {rec}")
        extra[name] = rec

    try:
        cpu_fps = torch_cpu_lifting_rate()
        vs = {"vs_baseline": extra["lifting_infer"]["items_per_s"] / cpu_fps,
              "torch_cpu_frames_per_s": cpu_fps}
    except (ImportError, KeyError) as e:
        vs = {"vs_baseline": None,
              "vs_baseline_reason": f"torch-CPU reference not measured: "
                                    f"{type(e).__name__}: {e}"}
    headline = extra["lifting_infer"].get("items_per_s", 0.0)
    extra.update({k: v for k, v in vs.items() if k != "vs_baseline"})
    print(json.dumps({
        "metric": "lifted frames/s (H3.6M 2D->3D, JointTransformerLifter "
                  "B=8192 bf16)",
        "value": headline,
        "unit": "frames/s",
        "vs_baseline": vs["vs_baseline"],
        "extra": extra,
    }), flush=True)


if __name__ == "__main__":
    main()
