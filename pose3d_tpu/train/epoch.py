"""Whole-epoch training as a single XLA program (lax.scan over batches).

The reference dispatches one python-loop iteration per batch
(train_1.py:73-100), a host round-trip per step. Here the entire epoch is one
jitted program: the epoch's shuffled batch stack lives in device memory and
``lax.scan`` drives the train step, so the host syncs once per epoch to read
the accumulated metrics.

The loss/metric accumulation reproduces the reference's conventions exactly:
epoch loss = mean over batches of per-batch mean loss (train_1.py:98);
MPJPE = per-joint sums accumulated over the epoch (train_1.py:100), finalized
by :func:`pose3d_tpu.losses.mpjpe_mm`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pose3d_tpu import losses
from pose3d_tpu.core.transforms import flip_pose
from pose3d_tpu.train.steps import LOSS_FNS, _apply


def make_lifter_epoch_fn(loss: str = "mse", donate: bool = True, mesh=None):
    """Build a jitted (state, y1_batches, y2_batches, rng) -> (state, metrics)
    whole-epoch function.

    y1_batches: (n_batches, B, 17, 2); y2_batches: (n_batches, B, 17, 3) —
    pre-shuffled on host (cheap: pure indexing) or on device.
    Metrics: {"loss": scalar epoch mean, "mpjpe_sums": (J,) epoch sums}.

    ``mesh``: data-parallel multi-chip epochs. The per-step gradient
    computation runs under ``shard_map`` over the mesh's data axis inside
    the scan body (see train.steps.make_dp_lifter_train_step for the
    single-step variant and the numerical contract). Stats-free models
    only.
    """
    loss_fn_ = LOSS_FNS[loss]
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from pose3d_tpu.parallel.mesh import DATA_AXIS

    def epoch(state, y1_batches, y2_batches, rng):
        n_batches = y1_batches.shape[0]
        if mesh is not None and state.batch_stats:
            raise ValueError(
                "mesh epochs support stats-free models only; BatchNorm "
                "models go through the GSPMD jit path")

        def grad_and_metrics(state, y1, y2, step_rng):
            def loss_fn(params):
                out, new_bs = _apply(state, params, y1, train=True,
                                     rng=step_rng)
                pred = out.reshape(y2.shape)
                return loss_fn_(pred, y2), (pred, new_bs)

            (loss_val, (pred, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            return loss_val, grads, new_bs, losses.loss_mpjpe(pred, y2)

        def grad_and_metrics_dp(state, y1, y2, step_rng):
            apply_fn = state.apply_fn  # static — safe to close over

            def per_shard(params, y1s, y2s, r):
                r = jax.random.fold_in(r, jax.lax.axis_index(DATA_AXIS))

                def loss_fn(p):
                    out = apply_fn({"params": p}, y1s, train=True,
                                   rngs={"dropout": r})
                    pred = out.reshape(y2s.shape)
                    return loss_fn_(pred, y2s), pred

                (lv, pred), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                lv = jax.lax.pmean(lv, DATA_AXIS)
                grads = jax.lax.pmean(grads, DATA_AXIS)
                mpjpe = jax.lax.psum(losses.loss_mpjpe(pred, y2s), DATA_AXIS)
                return lv, grads, mpjpe

            lv, grads, mpjpe = jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P()),
                out_specs=(P(), P(), P()),
                # the explicit pmean above reduces the grads; vma tracking would
                # also psum the gradient of the replicated params, doubling it up
                check_vma=False,
            )(state.params, y1, y2, step_rng)
            return lv, grads, None, mpjpe

        def body(carry, xs):
            state = carry
            y1, y2, step_rng = xs
            fn = grad_and_metrics if mesh is None else grad_and_metrics_dp
            loss_val, grads, new_bs, mpjpe = fn(state, y1, y2, step_rng)
            state = state.with_lr(state.plateau.lr)
            state = state.apply_gradients(grads, new_bs)
            return state, (loss_val, mpjpe)

        rngs = jax.random.split(rng, n_batches)
        state, (loss_per_batch, mpjpe_per_batch) = jax.lax.scan(
            body, state, (y1_batches, y2_batches, rngs)
        )
        metrics = {
            "loss": jnp.mean(loss_per_batch),
            "last_batch_loss": loss_per_batch[-1],
            "mpjpe_sums": jnp.sum(mpjpe_per_batch, axis=0),
        }
        return state, metrics

    return jax.jit(epoch, donate_argnums=(0,) if donate else ())


def make_lifter_eval_epoch_fn(loss: str = "mse", flip_tta: bool = False):
    """Jitted whole-epoch evaluation: (state, y1_batches, y2_batches) ->
    {"loss", "mpjpe_sums"}. Flip TTA averages predictions over
    {identity, flip} (train_1.py Flip-path intent; see steps.py)."""
    loss_fn_ = LOSS_FNS[loss]

    def epoch(state, y1_batches, y2_batches):
        def body(carry, xs):
            y1, y2 = xs
            pred, _ = _apply(state, state.params, y1, train=False)
            pred = pred.reshape(y2.shape)
            if flip_tta:
                pred_f, _ = _apply(state, state.params, flip_pose(y1), train=False)
                pred = (flip_pose(pred_f.reshape(y2.shape)) + pred) / 2.0
            return carry, (loss_fn_(pred, y2), losses.loss_mpjpe(pred, y2))

        _, (loss_per_batch, mpjpe_per_batch) = jax.lax.scan(
            body, None, (y1_batches, y2_batches)
        )
        return {
            "loss": jnp.mean(loss_per_batch),
            "mpjpe_sums": jnp.sum(mpjpe_per_batch, axis=0),
        }

    return jax.jit(epoch)


def stack_batches(arrays, batch_size: int, rng=None):
    """Host-side: shuffle and reshape (N, ...) arrays into
    (n_batches, batch_size, ...), dropping the remainder (static shapes for
    jit; the reference's DataLoader keeps partial batches, a documented
    deviation that only perturbs epoch boundaries)."""
    import numpy as np

    n = len(arrays[0])
    idx = rng.permutation(n) if rng is not None else np.arange(n)
    n_batches = n // batch_size
    idx = idx[: n_batches * batch_size]
    return tuple(
        a[idx].reshape(n_batches, batch_size, *a.shape[1:]) for a in arrays
    )
