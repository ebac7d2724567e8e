"""Temporal training under the mesh through the shard_map DP step.

``train.steps.make_dp_lifter_train_step`` shard_maps the grad computation
over the data axis and pmeans grads/loss. These tests prove that path
numerically identical to the single-device global-batch step — the same
oracle pattern as test_mesh_image/test_mesh_loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.models.temporal import TemporalLifter
from pose3d_tpu.parallel.mesh import make_mesh
from pose3d_tpu.train.state import create_train_state
from pose3d_tpu.train.steps import (
    make_dp_lifter_train_step,
    make_lifter_train_step,
)

B, T, NB = 8, 12, 2


@pytest.fixture(scope="module")
def temporal_state():
    # SGD: post-step params are LINEAR in the gradients, so DP-vs-global
    # equivalence is exact up to f32 reduction order (Adam's first step is
    # elementwise sign descent — near-zero grads flip sign under reduction
    # noise and diverge by +-lr, which would force a vacuous tolerance)
    model = TemporalLifter(clip_len=T, hidden=64, n_blocks=NB, heads=4)
    return create_train_state(model, jax.random.key(0),
                              jnp.zeros((B, T, 17, 2)), lr=1e-3,
                              optimizer="sgd")


class TestDPTemporalStep:
    def test_matches_single_device_global_batch(self, devices, temporal_state):
        rng = np.random.default_rng(0)
        # skewed batch: per-shard statistics differ, so a broken reduction
        # (sum-vs-mean, missing pmean) cannot cancel out
        y1 = jnp.asarray(
            (rng.random((B, T, 17, 2)) * np.arange(1, B + 1)
             .reshape(B, 1, 1, 1)).astype(np.float32))
        y2 = jnp.asarray(rng.random((B, T, 17, 3)).astype(np.float32) - 0.5)
        key = jax.random.key(1)

        one = make_lifter_train_step(donate=False)
        s_one, m_one = one(temporal_state, y1, y2, key)

        mesh = make_mesh()  # 8 virtual devices on the data axis
        dp = make_dp_lifter_train_step(mesh, donate=False)
        s_dp, m_dp = dp(temporal_state, y1, y2, key)

        np.testing.assert_allclose(float(m_dp["loss"]),
                                   float(m_one["loss"]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(m_dp["mpjpe_sums"]),
                                   np.asarray(m_one["mpjpe_sums"]),
                                   rtol=1e-5)
        flat_a = jax.tree_util.tree_leaves_with_path(s_dp.params)
        flat_b = jax.tree_util.tree_leaves(s_one.params)
        for (path, a), b in zip(flat_a, flat_b):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-6, rtol=1e-5,
                err_msg=jax.tree_util.keystr(path))

    @pytest.mark.slow

    def test_mesh_epoch_matches_single_device(self, devices, temporal_state):
        """Whole-epoch scan with the shard_map DP grads inside the body:
        3 batches through the mesh epoch == 3 batches single-device."""
        from pose3d_tpu.train.epoch import make_lifter_epoch_fn

        rng = np.random.default_rng(2)
        y1 = jnp.asarray(rng.random((3, B, T, 17, 2)).astype(np.float32))
        y2 = jnp.asarray(
            rng.random((3, B, T, 17, 3)).astype(np.float32) - 0.5)
        key = jax.random.key(5)

        e_one = make_lifter_epoch_fn(donate=False)
        s_one, m_one = e_one(temporal_state, y1, y2, key)
        e_dp = make_lifter_epoch_fn(donate=False, mesh=make_mesh())
        s_dp, m_dp = e_dp(temporal_state, y1, y2, key)

        # 3 compounding SGD steps: f32 reduction-order noise accumulates
        np.testing.assert_allclose(float(m_dp["loss"]),
                                   float(m_one["loss"]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(m_dp["mpjpe_sums"]),
                                   np.asarray(m_one["mpjpe_sums"]),
                                   rtol=1e-5)
        flat_a = jax.tree_util.tree_leaves_with_path(s_dp.params)
        flat_b = jax.tree_util.tree_leaves(s_one.params)
        for (path, a), b in zip(flat_a, flat_b):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-5,
                err_msg=jax.tree_util.keystr(path))

    def test_batch_stats_models_rejected(self, devices):
        from pose3d_tpu.models.lifters import MartinezLifter

        model = MartinezLifter()
        state = create_train_state(model, jax.random.key(0),
                                   jnp.zeros((8, 17, 2)), lr=1e-3)
        dp = make_dp_lifter_train_step(make_mesh(), donate=False)
        with pytest.raises(ValueError, match="stats-free"):
            dp(state, jnp.zeros((8, 17, 2)), jnp.zeros((8, 17, 3)),
               jax.random.key(1))
