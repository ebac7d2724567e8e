"""Smoke run of the lifting stack on one GPU, through its public entry points.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: data-parallel phases only

Phases, each at the full width of the flagship models, random weights from
fixed seeds:

1. device: JAX must run on a GPU (anything else is an error); prints the
   card, its power limit, the JAX version, optional packages, XLA_FLAGS and
   the compile-cache directory.
2. serve: ``LifterService`` over the bf16 ``JointTransformerLifter``
   (hidden 256, 2 blocks, 4 heads, 17 joints) answers N = 1, 100, 8192 and
   10000; each answer is compared with the same params through a float32
   apply at ``highest`` matmul precision.
3. temporal_train: ``cli.train_temporal.train`` at clip 243, hidden 256,
   5 blocks, 8 heads on synthetic clips; the loss must be finite and fall.
4. temporal_serve: ``pipeline.lift.lift_sequence`` on 500 frames
   (overlapping clips and an anchored tail) against a float32 reference.
5. direct_train: the R50 volumetric train step, B=64 at 256x256, when
   flax (which the image models use) is installed.

With ``--chips 4``: the GSPMD data-parallel temporal train step over a 4x1
(data, model) mesh against one card on the same global batch, and the same
for the global-BatchNorm direct step when flax is installed.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# Tolerances, as max|got - ref| <= tol * max|ref|:
# bfloat16 keeps 8 significant bits (relative rounding 2^-9 ~ 2e-3 per
# operation); through two pre-LN transformer blocks the rounding of every
# matmul input and residual add compounds to about 1e-2 of the output scale.
TOL_BF16_LIFTER = 3e-2
# the temporal lifter stacks 5 blocks of two attention+MLP sub-blocks each,
# 10 residual stages against the lifter's 2: twice the lifter's budget
TOL_BF16_TEMPORAL = 6e-2
# float32 matmuls run in TF32 (10 mantissa bits, ~1e-3 relative) unless
# asked for `highest`; LayerNorm and softmax stay float32
TOL_TF32 = 1e-2
# data-parallel vs one card, float32 at `highest`: only the order of the
# batch reductions differs, so agreement is to float32 rounding, ~1e-6
# relative; params are compared against the size of the SGD update, whose
# learning rate of 1 lifts it far above the float32 rounding of the params
TOL_DP_LOSS = 1e-5
TOL_DP_UPDATE = 1e-3
DP_LR = 1.0
# with BatchNorm the backward pass subtracts batch means of the incoming
# gradient, cancelling sums whose reduction order differs between one card
# and four; at small batches this reaches a few 1e-2 of the update
# (2.3e-2 measured on CPU at B=4, 32x32). A wrong all-reduce is off by 100%
# or more. The running statistics are forward sums: float32 rounding only.
TOL_DP_UPDATE_BN = 5e-2
TOL_DP_STATS = 1e-5

FULL = {
    "serve_requests": (1, 100, 8192, 10000),
    "serve_max_batch": 8192,
    "lifter": {},  # JointTransformerLifter defaults: 17 x 256, 2 blocks
    "temporal": {"clip_len": 243, "hidden": 256, "n_blocks": 5, "heads": 8},
    "temporal_batch": 8,
    "temporal_epochs": 4,
    "serve_frames": 500,
    "direct": {"architecture": "resnet50", "depth": 64},
    "direct_batch": 64,
    "image": 256,
    "direct_steps": 3,
}

ONE_CARD = ("serve", "temporal_train", "temporal_serve", "direct_train")
FOUR_CARDS = ("dp_temporal_train", "dp_direct_train")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max|diff|/max|ref| = {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def has_flax() -> bool:
    return importlib.util.find_spec("flax") is not None


def phases(chips: int) -> tuple:
    """Phases to run: the data-parallel ones on four cards, the rest on
    one; the image-model phases only where flax is installed."""
    names = FOUR_CARDS if chips == 4 else ONE_CARD
    return tuple(n for n in names if "direct" not in n or has_flax())


def phase_device(chips: int) -> dict:
    import jax

    from pose3d_tpu.utils.runtime import device_info, nvidia_smi

    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: JAX runs on {info['platform']!r}, "
                         "not a GPU; nothing was measured")
    if info["count"] < chips:
        raise SystemExit(f"chip_smoke: {chips} cards asked for, JAX sees "
                         f"{info['count']}")
    log(f"device: {info}")
    log(f"nvidia-smi: {nvidia_smi()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    for mod in ("flax", "orbax.checkpoint", "torch", "cv2"):
        ok = importlib.util.find_spec(mod.split(".")[0]) is not None
        log(f"  {mod}: {'installed' if ok else 'not installed'}")
    if not has_flax():
        log("direct_train phases left out: flax is not installed, and the "
            "image models (models/resnet.py, heads.py) are flax modules")
    return info


def phase_serve(size: dict) -> None:
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.lifters import JointTransformerLifter
    from pose3d_tpu.serving import LifterService

    model = JointTransformerLifter(dtype=jnp.bfloat16, **size["lifter"])
    ref_model = JointTransformerLifter(**size["lifter"])
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, model.n_joints, model.in_dim))))(
            jax.random.key(0))["params"]
    t0 = time.perf_counter()
    svc = LifterService(model, params, max_batch=size["serve_max_batch"])
    svc.warmup()
    log(f"serve: buckets {svc.buckets}, warm-up {time.perf_counter() - t0:.1f}"
        " s")
    top = jnp.zeros((svc.buckets[-1], model.n_joints, model.in_dim))
    mem = svc._fn.lower(top).compile().memory_analysis()
    log(f"  top bucket memory_analysis: {mem}")

    ref_apply = jax.jit(lambda p, x: ref_model.apply({"params": p}, x))
    rng = np.random.default_rng(1)
    for n in size["serve_requests"]:
        kp = rng.random((n, model.n_joints, model.in_dim)).astype(np.float32)
        got = svc.lift(kp)
        assert got.shape == (n, model.n_joints, 3) and np.isfinite(got).all()
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(ref_apply(params, kp))
        check(f"N={n} bf16 service vs f32 highest", rel_err(got, ref),
              TOL_BF16_LIFTER)
        if n == size["serve_requests"][-1]:
            tf32 = np.asarray(ref_apply(params, kp))
            check(f"N={n} f32 default precision vs highest",
                  rel_err(tf32, ref), TOL_TF32)


def read_losses(log_dir: str, run: str) -> list:
    path = os.path.join(log_dir, "runs", f"{run}.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r["train_loss"] for r in recs if "train_loss" in r]


def phase_temporal_train(size: dict) -> None:
    from pose3d_tpu.cli.train_temporal import train
    from pose3d_tpu.config import DataConfig, TemporalConfig

    tcfg = size["temporal"]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = TemporalConfig(
            **tcfg, batch_size=size["temporal_batch"],
            n_epochs=size["temporal_epochs"], lr=1e-3, run_name="smoke",
            log_dir=log_dir, data=DataConfig(
                synthetic_frames=4 * size["temporal_batch"]
                * tcfg["clip_len"]))
        t0 = time.perf_counter()
        train(cfg)
        losses = read_losses(log_dir, "smoke")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log(f"temporal_train: epoch losses {losses} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"temporal loss did not fall: {losses}")


def phase_temporal_serve(size: dict) -> None:
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter, clip_starts
    from pose3d_tpu.pipeline.lift import lift_sequence

    tcfg = size["temporal"]
    model = TemporalLifter(dtype=jnp.bfloat16, **tcfg)
    ref_model = TemporalLifter(**tcfg)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, tcfg["clip_len"], 17, 2))))(
            jax.random.key(2))["params"]
    n = size["serve_frames"]
    kp = np.random.default_rng(3).random((n, 17, 2)).astype(np.float32)
    kp *= 1000.0
    starts = clip_starts(n, tcfg["clip_len"], tcfg["clip_len"] // 2)
    got = lift_sequence(params, model, kp)
    assert got.shape == (n, 17, 3) and np.isfinite(got).all()
    with jax.default_matmul_precision("highest"):
        ref = lift_sequence(params, ref_model, kp)
    log(f"temporal_serve: {n} frames, clip starts {starts}")
    check("bf16 lift_sequence vs f32 highest", rel_err(got, ref),
          TOL_BF16_TEMPORAL)


def _direct_setup(size: dict, dtype, lr: float = 1e-3):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet3D
    from pose3d_tpu.train.state import create_train_state

    b, hw = size["direct_batch"], size["image"]
    model = PoseNet3D(return_heatmap=False, dtype=dtype, **size["direct"])
    state = create_train_state(model, jax.random.key(4),
                               jnp.zeros((2, hw, hw, 3)), lr=lr,
                               optimizer="sgd")
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)
    kp = (rng.random((b, 17, 3), np.float32) - 0.5)
    return state, frames, kp


def phase_direct_train(size: dict) -> None:
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.image_steps import make_direct_train_step

    state, frames, kp = _direct_setup(size, jnp.bfloat16)
    step = make_direct_train_step()
    losses = []
    for i in range(size["direct_steps"]):
        state, m = step(state, frames, kp, jax.random.key(i))
        losses.append(float(m["loss"]))
    log(f"direct_train: losses {losses}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"direct loss not finite: {losses}")


def _max_diff(a, b) -> float:
    import jax

    return max((float(np.max(np.abs(np.asarray(x, np.float64)
                                    - np.asarray(y, np.float64))))
                for x, y in zip(jax.tree_util.tree_leaves(a),
                                jax.tree_util.tree_leaves(b))), default=0.0)


def _compare_dp(name, one, dp, state0, tol_update=TOL_DP_UPDATE) -> None:
    """Loss, updated params and BatchNorm running statistics of a
    data-parallel step against one card."""
    import jax

    (s_one, m_one), (s_dp, m_dp) = one, dp
    l_one, l_dp = float(m_one["loss"]), float(m_dp["loss"])
    log(f"{name}: loss one card {l_one:.6f}, data-parallel {l_dp:.6f}")
    check(f"{name} loss", abs(l_dp - l_one) / abs(l_one), TOL_DP_LOSS)
    upd = _max_diff(s_one.params, state0.params)
    check(f"{name} params (vs SGD update {upd:.3e})",
          _max_diff(s_dp.params, s_one.params) / upd, tol_update)
    if jax.tree_util.tree_leaves(s_one.batch_stats):
        scale = max(float(np.max(np.abs(np.asarray(x))))
                    for x in jax.tree_util.tree_leaves(s_one.batch_stats))
        check(f"{name} BatchNorm running stats",
              _max_diff(s_dp.batch_stats, s_one.batch_stats) / scale,
              TOL_DP_STATS)


def _dp_run(make_step, state, batch, key, devices):
    """One step on devices[0] and one GSPMD step over a (len(devices), 1)
    mesh, both on the same global batch."""
    import jax

    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated

    dev0 = jax.sharding.SingleDeviceSharding(devices[0])
    one = make_step(donate=False)(jax.device_put(state, dev0),
                                  *jax.device_put(batch, dev0), key)
    mesh = make_mesh(n_data=len(devices), n_model=1, devices=devices)
    dp = make_step(donate=False)(
        jax.device_put(state, replicated(mesh)),
        *jax.device_put(batch, batch_sharding(mesh)), key)
    return one, dp


def phase_dp_temporal_train(size: dict, devices) -> None:
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.train.state import create_train_state
    from pose3d_tpu.train.steps import make_lifter_train_step

    tcfg = size["temporal"]
    b, t = size["temporal_batch"], tcfg["clip_len"]
    model = TemporalLifter(**tcfg)
    rng = np.random.default_rng(6)
    # skewed batch: each shard has its own scale, so a missing or wrong
    # cross-device reduction cannot cancel out
    y1 = (rng.random((b, t, 17, 2)) * np.arange(1, b + 1)[:, None, None, None]
          ).astype(np.float32)
    y2 = (rng.random((b, t, 17, 3)) - 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        state = create_train_state(model, jax.random.key(7),
                                   jnp.zeros((2, t, 17, 2)), lr=DP_LR,
                                   optimizer="sgd")
        one, dp = _dp_run(make_lifter_train_step, state, (y1, y2),
                          jax.random.key(8), devices)
    _compare_dp("dp_temporal_train", one, dp, state)


def phase_dp_direct_train(size: dict, devices) -> None:
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.image_steps import make_direct_train_step

    with jax.default_matmul_precision("highest"):
        state, frames, kp = _direct_setup(size, jnp.float32, lr=DP_LR)
        one, dp = _dp_run(make_direct_train_step, state, (frames, kp),
                          jax.random.key(9), devices)
    _compare_dp("dp_direct_train (global BatchNorm)", one, dp, state,
                TOL_DP_UPDATE_BN)


def run(chips: int, size: dict) -> dict:
    """Run the phases for ``chips`` cards at ``size``; returns the device
    record of the result line. Tests call it with small sizes."""
    import jax

    from pose3d_tpu.utils.runtime import device_info

    devices = jax.devices()[:chips]
    for name in phases(chips):
        t0 = time.perf_counter()
        log(f"== {name}")
        fn = globals()[f"phase_{name}"]
        if chips == 4:
            fn(size, devices)
        else:
            fn(size)
        log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
    info = device_info()
    info["count"] = chips
    return info


def result_line(info: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    from pose3d_tpu.utils.runtime import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    phase_device(args.chips)
    info = run(args.chips, FULL)
    print(result_line(info), flush=True)


if __name__ == "__main__":
    sys.exit(main())
