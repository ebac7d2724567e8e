"""Image models under the device mesh: cross-replica BatchNorm semantics.

SURVEY.md section 2.7 names cross-replica BN statistics as the component to
find under "distributed backend" (the reference models are BN-heavy,
Resnet.py:25-28,60-66). Under GSPMD there is no hand-written psum: the train
step is jitted once over the whole logical batch, the batch axis is sharded
over the mesh's data axis, and XLA inserts the cross-device reductions that
make every jnp.mean over the batch a GLOBAL mean. These tests prove that:
the batch is deliberately skewed per shard (bright first half, dark second
half) so a per-device BN implementation (torch DataParallel-style) would
produce different statistics than the single-device global-batch oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D
from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from pose3d_tpu.train.state import create_train_state

B, HW = 16, 32  # 2 frames per device on the 8-device mesh


def _skewed_frames(rng):
    """Batch whose per-device shards have different statistics: the first
    half is bright (+0.6), the second half dark (-0.2 clipped at 0)."""
    frames = rng.random((B, HW, HW, 3), np.float32) * 0.4
    frames[: B // 2] += 0.6
    return frames


def _assert_tree_close(a, b, atol):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for (path, xa), xb in zip(flat_a, flat_b):
        np.testing.assert_allclose(
            np.asarray(xa), np.asarray(xb), atol=atol, rtol=1e-4,
            err_msg=jax.tree_util.keystr(path),
        )


class TestImageModelsUnderMesh:
    @pytest.mark.slow
    def test_posenet3d_dp_bn_matches_global_oracle(self, devices, rng):
        """Forward/backward of one DP step on the 8-device mesh ==
        single-device full-batch oracle: loss, GRADIENTS (the all-reduce XLA
        inserts) and BatchNorm batch_stats (the running stats updated from
        the global batch mean/var). The post-Adam params are deliberately
        NOT compared: for near-zero gradients the first Adam update is
        lr*g/(|g|+eps), which amplifies fp-reduction-order noise to O(lr) —
        the optimizer is elementwise and mesh-independent anyway."""
        mesh = make_mesh(n_data=8)
        frames = _skewed_frames(rng)
        kp3d = (rng.random((B, 17, 3), np.float32) - 0.5) * 1.5

        model = PoseNet3D(architecture="resnet18", depth=8,
                          return_heatmap=False)
        variables = model.init(
            {"params": jax.random.key(0)}, jnp.zeros((B, HW, HW, 3)),
            train=True,
        )

        @jax.jit
        def fwd_bwd(params, batch_stats, frames, kp3d):
            def loss_fn(p):
                (coords, _), updates = model.apply(
                    {"params": p, "batch_stats": batch_stats}, frames,
                    train=True, mutable=["batch_stats"],
                )
                pred = coords.reshape(kp3d.shape)
                return jnp.mean((pred - kp3d) ** 2), updates["batch_stats"]

            (loss, new_bs), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            return loss, new_bs, grads

        # single-device global-batch oracle
        ref_loss, ref_bs, ref_grads = fwd_bwd(
            variables["params"], variables["batch_stats"],
            jnp.asarray(frames), jnp.asarray(kp3d),
        )

        # 8-way data-parallel run on the same inputs
        p = jax.device_put(variables["params"], replicated(mesh))
        bs = jax.device_put(variables["batch_stats"], replicated(mesh))
        f = jax.device_put(jnp.asarray(frames), batch_sharding(mesh))
        y = jax.device_put(jnp.asarray(kp3d), batch_sharding(mesh))
        dp_loss, dp_bs, dp_grads = fwd_bwd(p, bs, f, y)

        assert len(f.sharding.device_set) == 8
        np.testing.assert_allclose(float(dp_loss), float(ref_loss), rtol=1e-5)
        _assert_tree_close(dp_bs, ref_bs, atol=1e-5)
        # Grads are large cancelling sums over batch*spatial (16k terms);
        # 8-way reduction-order drift reaches ~1e-4 absolute. A per-device
        # (unsynced) BN would diverge at O(1e-2) — well past this tolerance.
        _assert_tree_close(dp_grads, ref_grads, atol=3e-4)

        # The skew is real: a per-device BN would have seen shard means that
        # differ from the global mean by ~0.3 — far beyond the tolerance.
        shard_mean = frames[: B // 8].mean()
        assert abs(shard_mean - frames.mean()) > 0.1

class TestDPDirectShardMap:
    """make_dp_direct_train_step: the shard_map DP route for the direct
    model. With every shard fed the IDENTICAL batch, the step's local-BN
    semantics coincide with global BN, so the DP step must match the
    single-device step on one shard's batch EXACTLY: pmean over identical
    values is the identity, psum is x8."""

    def _parity(self, rng, image=64, b_shard=2):
        import jax.numpy as jnp

        from pose3d_tpu.models.heads import PoseNet3D
        from pose3d_tpu.train.image_steps import (
            make_direct_train_step,
            make_dp_direct_train_step,
        )

        mesh = make_mesh(n_data=8)
        model = PoseNet3D(architecture="resnet18", return_heatmap=False)
        shard_frames = rng.random((b_shard, image, image, 3), np.float32)
        shard_kp = (rng.random((b_shard, 17, 3), np.float32) - 0.5) * 1.5
        frames = np.tile(shard_frames, (8, 1, 1, 1))
        kp3d = np.tile(shard_kp, (8, 1, 1))

        state = create_train_state(
            model, jax.random.key(0), jnp.zeros((b_shard, image, image, 3)),
            lr=1e-3, optimizer="adam", weight_decay=1e-8)
        dp_step = make_dp_direct_train_step(mesh, donate=False)
        one_step = make_direct_train_step(donate=False)

        dp_state, dp_m = dp_step(state, jnp.asarray(frames),
                                 jnp.asarray(kp3d), jax.random.key(7))
        ref_state, ref_m = one_step(state, jnp.asarray(shard_frames),
                                    jnp.asarray(shard_kp),
                                    jax.random.key(7))
        np.testing.assert_allclose(float(dp_m["loss"]),
                                   float(ref_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(dp_m["mpjpe_sums"]),
                                   8 * np.asarray(ref_m["mpjpe_sums"]),
                                   rtol=1e-4)
        _assert_tree_close(dp_state.params, ref_state.params, atol=1e-5)
        _assert_tree_close(dp_state.batch_stats, ref_state.batch_stats,
                           atol=1e-5)

    def test_plumbing_matches_single_device(self, devices, rng):
        """Fast check of the shard_map wiring."""
        self._parity(rng, image=32)

    @pytest.mark.slow
    def test_skewed_shards_local_bn_contract(self, devices, rng):
        """Distinct shards: the step runs (finite metrics, params move) and
        the averaged running stats differ from the global-batch oracle's —
        i.e. the documented torch-DDP local-BN semantics, not a silent
        global-BN claim."""
        import jax.numpy as jnp

        from pose3d_tpu.models.heads import PoseNet3D
        from pose3d_tpu.train.image_steps import (
            make_direct_train_step,
            make_dp_direct_train_step,
        )

        mesh = make_mesh(n_data=8)
        model = PoseNet3D(architecture="resnet18", return_heatmap=False)
        frames = _skewed_frames(rng)
        kp3d = (rng.random((B, 17, 3), np.float32) - 0.5) * 1.5
        state = create_train_state(
            model, jax.random.key(0), jnp.zeros((B, HW, HW, 3)), lr=1e-3)
        dp_state, dp_m = make_dp_direct_train_step(mesh, donate=False)(
            state, jnp.asarray(frames), jnp.asarray(kp3d),
            jax.random.key(3))
        assert np.isfinite(float(dp_m["loss"]))
        ref_state, _ = make_direct_train_step(donate=False)(
            state, jnp.asarray(frames), jnp.asarray(kp3d),
            jax.random.key(3))
        # BN variances: local average must differ from the global-batch
        # value on a skewed batch (the shard means differ from the global
        # mean by ~0.3 -> missing between-shard variance is O(1e-1))
        var_dp = np.asarray(jax.tree_util.tree_leaves(
            dp_state.batch_stats)[1])
        var_ref = np.asarray(jax.tree_util.tree_leaves(
            ref_state.batch_stats)[1])
        assert not np.allclose(var_dp, var_ref, atol=1e-6)


class TestImageModelsUnderMesh2:
    @pytest.mark.slow

    def test_posenet2d_dp_bn_matches_global_oracle(self, devices, rng):
        """Same property for the 2D head (reference Model_2D, the phase-5
        trained model)."""
        mesh = make_mesh(n_data=8)
        frames = _skewed_frames(rng)
        kp2d = rng.random((B, 17, 2), np.float32)

        model = PoseNet2D(architecture="resnet18")
        state = create_train_state(
            model, jax.random.key(0), jnp.zeros((B, HW, HW, 3)), lr=1e-3
        )

        @jax.jit
        def step(state, frames, kp2d, rng_key):
            def loss_fn(params):
                variables = {"params": params,
                             "batch_stats": state.batch_stats}
                coords, updates = state.apply_fn(
                    variables, frames, train=True, rngs={"dropout": rng_key},
                    mutable=["batch_stats"],
                )
                pred = coords.reshape(kp2d.shape)
                return jnp.mean((pred - kp2d) ** 2), updates["batch_stats"]

            (loss, new_bs), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            state = state.with_lr(state.plateau.lr)
            return state.apply_gradients(grads, new_bs), loss

        ref_state, ref_loss = step(
            state, jnp.asarray(frames), jnp.asarray(kp2d), jax.random.key(1)
        )
        dp_state = jax.device_put(state, replicated(mesh))
        f = jax.device_put(jnp.asarray(frames), batch_sharding(mesh))
        y = jax.device_put(jnp.asarray(kp2d), batch_sharding(mesh))
        dp_state, dp_loss = step(dp_state, f, y, jax.random.key(1))

        np.testing.assert_allclose(float(dp_loss), float(ref_loss), rtol=1e-5)
        _assert_tree_close(dp_state.batch_stats, ref_state.batch_stats,
                           atol=1e-5)
