"""Jitted train/eval steps for the direct image->3D models (phases 3/4/5).

Reference loop bodies: phase3 train_3.py:60-97 (MSE on soft-argmax coords,
Adam wd 1e-8), phase4 train.py (same shape, z_scale 2.0), with the optional
heatmap-MSE supervision phase5 keeps commented (train_5.py:187-189) exposed
as ``heatmap_loss_weight``.

Design details:
- the 17x64^3 Gaussian targets are synthesized ON DEVICE inside the step
  (pose3d_tpu.ops.heatmap) instead of the reference's per-item host numpy
  build (H36_dataset.py:196-202) — the dominant host-side cost in the
  reference's input pipeline (SURVEY.md section 3.1);
- steps never sync to host; metrics return as device scalars the epoch loop
  collects and reads once per epoch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pose3d_tpu import losses
from pose3d_tpu.ops.heatmap import heatmap_targets
from pose3d_tpu.train.steps import LOSS_FNS


def _normalize(frames):
    """uint8 frames normalize on device (the /256 convention,
    H36_dataset.py:131); float frames pass through already normalized."""
    if jnp.issubdtype(frames.dtype, jnp.integer):
        return frames.astype(jnp.float32) / 256.0
    return frames


def make_direct_train_step(loss: str = "mse", heatmap_loss_weight: float = 0.0,
                           donate: bool = True):
    """(state, frames (B,H,W,3) float or uint8, kp3d (B,17,3), rng) ->
    (state, metrics).

    The model is a PoseNet3D-style apply returning (coords (B,51), heatmap).
    """
    loss_fn_ = LOSS_FNS[loss]

    def step(state, frames, kp3d, rng):
        frames = _normalize(frames)

        def loss_fn(params):
            variables = {"params": params, "batch_stats": state.batch_stats}
            (coords, hm), updates = state.apply_fn(
                variables, frames, train=True, rngs={"dropout": rng},
                mutable=["batch_stats"],
            )
            pred = coords.reshape(kp3d.shape)
            total = loss_fn_(pred, kp3d)
            if heatmap_loss_weight:
                hm_gt = heatmap_targets(jnp.clip(kp3d, -1.0, 1.0),
                                        grid=hm.shape[-3:])
                total = total + heatmap_loss_weight * losses.mse(hm, hm_gt)
            return total, (pred, updates["batch_stats"])

        (loss_val, (pred, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        state = state.with_lr(state.plateau.lr)
        state = state.apply_gradients(grads, new_bs)
        return state, {
            "loss": loss_val,
            "mpjpe_sums": losses.loss_mpjpe(pred, kp3d),
        }

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_direct_chunk_step(loss: str = "mse",
                           heatmap_loss_weight: float = 0.0,
                           donate: bool = True,
                           unroll: bool | int = False):
    """Multi-batch step: (state, frames (K,B,H,W,3), kp3d (K,B,17,3), rng)
    -> (state, metrics summed/averaged over the K scanned batches).

    One dispatch drives K optimizer steps, so the host launches once per
    K batches. Frames may be uint8 (normalized on device).

    ``unroll``: forwarded to ``lax.scan``; unrolling can help tiny models
    where per-iteration scan overhead is visible; compile time grows with K.
    """
    loss_fn_ = LOSS_FNS[loss]

    def step(state, frames, kp3d, rng):
        k = frames.shape[0]

        def body(st, xs):
            f, y, r = xs
            f = _normalize(f)

            def loss_fn(params):
                variables = {"params": params, "batch_stats": st.batch_stats}
                (coords, hm), updates = st.apply_fn(
                    variables, f, train=True, rngs={"dropout": r},
                    mutable=["batch_stats"],
                )
                pred = coords.reshape(y.shape)
                total = loss_fn_(pred, y)
                if heatmap_loss_weight:
                    hm_gt = heatmap_targets(jnp.clip(y, -1.0, 1.0),
                                            grid=hm.shape[-3:])
                    total = total + heatmap_loss_weight * losses.mse(hm, hm_gt)
                return total, (pred, updates["batch_stats"])

            (l, (pred, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(st.params)
            st = st.with_lr(st.plateau.lr)
            st = st.apply_gradients(grads, new_bs)
            return st, (l, losses.loss_mpjpe(pred, y))

        rngs = jax.random.split(rng, k)
        state, (loss_k, mpjpe_k) = jax.lax.scan(
            body, state, (frames, kp3d, rngs), unroll=unroll
        )
        return state, {
            "loss": jnp.mean(loss_k),
            "last_batch_loss": loss_k[-1],
            "mpjpe_sums": jnp.sum(mpjpe_k, axis=0),
        }

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_dp_direct_train_step(mesh, loss: str = "mse",
                              donate: bool = True):
    """Data-parallel direct-model train step via ``shard_map``: each shard
    runs the identical single-device program on its batch slice; loss/grads
    ``pmean`` and per-joint MPJPE sums ``psum`` over the data axis. The
    GSPMD route (``make_direct_train_step`` under a mesh,
    tests/test_mesh_image.py) is the other data-parallel path.

    BatchNorm contract (differs from the GSPMD path): torch-DDP-style
    LOCAL BN — each shard normalizes with its own shard's batch
    statistics, and the updated running stats are pmean-averaged across
    shards (the average of per-shard batch means IS the global batch
    mean for equal shards; the averaged variance omits the between-shard
    mean spread, exactly as torch DDP without SyncBatchNorm). Exact
    global-batch BN stays on the GSPMD path.
    """
    from jax.sharding import PartitionSpec as P

    from pose3d_tpu.parallel.mesh import DATA_AXIS

    loss_fn_ = LOSS_FNS[loss]

    def step(state, frames, kp3d, rng):
        apply_fn = state.apply_fn  # static — safe to close over

        def per_shard(params, batch_stats, f, y, r):
            r = jax.random.fold_in(r, jax.lax.axis_index(DATA_AXIS))
            f = _normalize(f)

            def loss_fn(p):
                variables = {"params": p, "batch_stats": batch_stats}
                (coords, _hm), updates = apply_fn(
                    variables, f, train=True, rngs={"dropout": r},
                    mutable=["batch_stats"],
                )
                pred = coords.reshape(y.shape)
                return loss_fn_(pred, y), (pred, updates["batch_stats"])

            (lv, (pred, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            lv = jax.lax.pmean(lv, DATA_AXIS)
            grads = jax.lax.pmean(grads, DATA_AXIS)
            new_bs = jax.lax.pmean(new_bs, DATA_AXIS)
            mpjpe = jax.lax.psum(losses.loss_mpjpe(pred, y), DATA_AXIS)
            return lv, grads, new_bs, mpjpe

        loss_val, grads, new_bs, mpjpe = jax.shard_map(
            per_shard, mesh=mesh,
            in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=(P(), P(), P(), P()),
            # the explicit pmean above reduces the grads; vma tracking would
            # also psum the gradient of the replicated params, doubling it up
            check_vma=False,
        )(state.params, state.batch_stats, frames, kp3d, rng)
        state = state.with_lr(state.plateau.lr)
        state = state.apply_gradients(grads, new_bs)
        return state, {"loss": loss_val, "mpjpe_sums": mpjpe}

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_direct_eval_chunk_step(loss: str = "mse"):
    """Whole-eval-set step: (state, frames (K,B,H,W,3), kp3d (K,B,17,3)) ->
    {"loss" mean, "mpjpe_sums"} in ONE dispatch (lax.scan over batches)."""
    loss_fn_ = LOSS_FNS[loss]

    def step(state, frames, kp3d):
        variables = {"params": state.params, "batch_stats": state.batch_stats}

        def body(carry, xs):
            f, y = xs
            coords, _ = state.apply_fn(variables, _normalize(f), train=False)
            pred = coords.reshape(y.shape)
            return carry, (loss_fn_(pred, y), losses.loss_mpjpe(pred, y))

        _, (loss_k, mpjpe_k) = jax.lax.scan(body, None, (frames, kp3d))
        return {"loss": jnp.mean(loss_k), "mpjpe_sums": jnp.sum(mpjpe_k, 0)}

    return jax.jit(step)


def make_direct_eval_step(loss: str = "mse"):
    loss_fn_ = LOSS_FNS[loss]

    def step(state, frames, kp3d):
        frames = _normalize(frames)
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        coords, _ = state.apply_fn(variables, frames, train=False)
        pred = coords.reshape(kp3d.shape)
        return {
            "loss": loss_fn_(pred, kp3d),
            "mpjpe_sums": losses.loss_mpjpe(pred, kp3d),
            "pred": pred,
        }

    return jax.jit(step)


def make_detector_chunk_step(image_size: int = 256, donate: bool = True):
    """2D-detector distillation step: (state, kp2d (K,B,17,2), rng) ->
    (state, metrics). The training FRAMES are rendered on device inside the
    step (data/synthetic.py::render_pose_frames) — only the (K,B,17,2)
    keypoints cross the wire, the 256^2 RGB batch never exists on the host.
    Supervision is MSE on the soft-argmax coords (the phase-5 Model_2D
    pathway, phase5_loop/Model_2d.py:96-138); ``px_err`` reports the mean
    euclidean error in rendered-image pixels.
    """
    from pose3d_tpu.data.synthetic import render_pose_frames

    def step(state, kp2d, rng):
        k = kp2d.shape[0]

        def body(st, xs):
            y, r = xs
            frames = render_pose_frames(y, r, size=image_size)

            def loss_fn(params):
                variables = {"params": params, "batch_stats": st.batch_stats}
                coords, updates = st.apply_fn(
                    variables, frames, train=True,
                    rngs={"dropout": jax.random.fold_in(r, 1)},
                    mutable=["batch_stats"],
                )
                pred = coords.reshape(y.shape)
                return losses.mse(pred, y), (pred, updates["batch_stats"])

            (l, (pred, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(st.params)
            st = st.with_lr(st.plateau.lr)
            st = st.apply_gradients(grads, new_bs)
            px = jnp.mean(jnp.linalg.norm(pred - y, axis=-1)) * image_size
            return st, (l, px)

        rngs = jax.random.split(rng, k)
        state, (loss_k, px_k) = jax.lax.scan(body, state, (kp2d, rngs))
        return state, {
            "loss": jnp.mean(loss_k),
            "last_batch_loss": loss_k[-1],
            "px_err": px_k[-1],
        }

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_detector_eval_step(image_size: int = 256):
    """(state, kp2d (K,B,17,2), rng) -> mean pixel error over all batches,
    frames rendered on device with the given key (deterministic per key)."""
    from pose3d_tpu.data.synthetic import render_pose_frames

    def step(state, kp2d, rng):
        variables = {"params": state.params, "batch_stats": state.batch_stats}

        def body(carry, xs):
            y, r = xs
            frames = render_pose_frames(y, r, size=image_size)
            coords = state.apply_fn(variables, frames, train=False)
            pred = coords.reshape(y.shape)
            return carry, jnp.mean(jnp.linalg.norm(pred - y, axis=-1))

        rngs = jax.random.split(rng, kp2d.shape[0])
        _, px = jax.lax.scan(body, None, (kp2d, rngs))
        return jnp.mean(px) * image_size

    return jax.jit(step)
