"""The phase-5 consistency loop under the device mesh.

This is the most failure-prone sharding case in the repo: TWO BatchNorm-
heavy CNNs (PoseNet2D + PoseNet3D) + two frozen transformers (lifter and
projector) + a flip-DOUBLED batch, all inside one backward
(reference contract phase5_loop/train_5.py:52-338; flip consistency
:153-168; single backward through both graphs :170-181).

Oracle pattern of tests/test_mesh_image.py: one DP train step on the
8-virtual-device mesh must equal a single-device global-batch run — loss,
every Triangle loss term, the gradients of BOTH trained models (the
all-reduces XLA inserts), and both models' BatchNorm batch statistics —
on a deliberately skewed batch where per-device (unsynced) BN would
diverge at O(1e-2). Note the flip-concat doubles the batch INSIDE the
step: the concatenated 2B batch keeps the batch axis sharded, so global
BN must reduce over the 2B frames across all devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D
from pose3d_tpu.models.lifters import JointTransformerLifter
from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from pose3d_tpu.train.loop_steps import (
    LoopState,
    loop_plateau_step,
    make_loop_train_step,
)
from pose3d_tpu.train.state import create_train_state

B, HW = 16, 32  # 2 frames per device on the 8-device mesh


def _assert_tree_close(a, b, atol, label=""):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for (path, xa), xb in zip(flat_a, flat_b):
        np.testing.assert_allclose(
            np.asarray(xa), np.asarray(xb), atol=atol, rtol=1e-4,
            err_msg=label + jax.tree_util.keystr(path),
        )


def _build_state(rng_seed=0):
    model2d = PoseNet2D(architecture="resnet18")
    model3d = PoseNet3D(architecture="resnet18", depth=8,
                        return_heatmap=True)
    lifter = JointTransformerLifter(hidden=64, n_blocks=1, heads=2)
    projector = JointTransformerLifter(in_dim=3, out_dim=2, hidden=64,
                                       n_blocks=1, heads=2)
    img0 = jnp.zeros((B, HW, HW, 3))
    lifter_vars = lifter.init({"params": jax.random.key(rng_seed + 2)},
                              jnp.zeros((B, 17, 2)), train=False)
    proj_vars = projector.init({"params": jax.random.key(rng_seed + 3)},
                               jnp.zeros((B, 17, 3)), train=False)
    state = LoopState(
        net2d=create_train_state(model2d, jax.random.key(rng_seed), img0,
                                 lr=1e-3),
        net3d=create_train_state(model3d, jax.random.key(rng_seed + 1), img0,
                                 lr=1e-3),
        lifter_params=lifter_vars["params"],
        projector_params=proj_vars["params"],
    )
    return state, lifter, projector


class TestLoopUnderMesh:
    @pytest.mark.slow
    def test_loop_dp_matches_global_oracle(self, devices, rng):
        """Full configuration — triangle (sep) + flip + project — DP over
        the 8-device mesh vs the single-device global-batch oracle."""
        mesh = make_mesh(n_data=8)
        frames = rng.random((B, HW, HW, 3), np.float32) * 0.4
        frames[: B // 2] += 0.6  # skewed: per-device BN stats would differ
        y1 = rng.random((B, 17, 2), np.float32)
        y2 = (rng.random((B, 17, 3), np.float32) - 0.5) * 1.5

        state, lifter, projector = _build_state()
        step = make_loop_train_step(
            lifter.apply, projector.apply, triangle=True, flip=True,
            project=True, triangle_mode="sep", donate=False,
            return_grads=True,
        )

        ref_state, ref_m = step(
            state, jnp.asarray(frames), jnp.asarray(y1), jnp.asarray(y2),
            jax.random.key(7),
        )

        dp_state = jax.device_put(state, replicated(mesh))
        f = jax.device_put(jnp.asarray(frames), batch_sharding(mesh))
        s1 = jax.device_put(jnp.asarray(y1), batch_sharding(mesh))
        s2 = jax.device_put(jnp.asarray(y2), batch_sharding(mesh))
        dp_state, dp_m = step(dp_state, f, s1, s2, jax.random.key(7))

        assert len(f.sharding.device_set) == 8
        for key in ("loss", "loss_2d", "loss_3d", "loss_lift", "loss_gap",
                    "loss_proj", "loss_proj_gap"):
            if key in ref_m:
                np.testing.assert_allclose(
                    float(dp_m[key]), float(ref_m[key]), rtol=2e-5,
                    err_msg=key,
                )
        # gradients of BOTH trained models: the all-reduce evidence
        _assert_tree_close(dp_m["g2d"], ref_m["g2d"], atol=3e-4, label="g2d")
        _assert_tree_close(dp_m["g3d"], ref_m["g3d"], atol=3e-4, label="g3d")
        # global-BN batch statistics of both CNNs (over the flip-doubled 2B)
        _assert_tree_close(dp_state.net2d.batch_stats,
                           ref_state.net2d.batch_stats, atol=1e-5,
                           label="bn2d")
        _assert_tree_close(dp_state.net3d.batch_stats,
                           ref_state.net3d.batch_stats, atol=1e-5,
                           label="bn3d")

        # the skew is real: shard mean differs from the global mean
        assert abs(frames[: B // 8].mean() - frames.mean()) > 0.1

        # plateau bookkeeping also runs sharded
        dp_state = loop_plateau_step(dp_state, dp_m["loss"])
        assert np.isfinite(float(dp_state.net2d.plateau.lr))

    @pytest.mark.slow

    def test_loop_cycle_mode_dp_matches_oracle(self, devices, rng):
        """The cycle TriangleLoss variant (losses.py:10-62) without flip:
        the lift term couples the two predictions inside one backward."""
        mesh = make_mesh(n_data=8)
        frames = rng.random((B, HW, HW, 3), np.float32) * 0.4
        frames[B // 2:] *= 0.2
        y1 = rng.random((B, 17, 2), np.float32)
        y2 = (rng.random((B, 17, 3), np.float32) - 0.5) * 1.5

        state, lifter, projector = _build_state(rng_seed=10)
        step = make_loop_train_step(
            lifter.apply, projector.apply, triangle=True, flip=False,
            project=False, triangle_mode="cycle", donate=False,
            return_grads=True,
        )
        ref_state, ref_m = step(
            state, jnp.asarray(frames), jnp.asarray(y1), jnp.asarray(y2),
            jax.random.key(3),
        )
        dp_state = jax.device_put(state, replicated(mesh))
        f = jax.device_put(jnp.asarray(frames), batch_sharding(mesh))
        s1 = jax.device_put(jnp.asarray(y1), batch_sharding(mesh))
        s2 = jax.device_put(jnp.asarray(y2), batch_sharding(mesh))
        dp_state, dp_m = step(dp_state, f, s1, s2, jax.random.key(3))

        np.testing.assert_allclose(float(dp_m["loss"]), float(ref_m["loss"]),
                                   rtol=2e-5)
        _assert_tree_close(dp_m["g2d"], ref_m["g2d"], atol=3e-4, label="g2d")
        _assert_tree_close(dp_m["g3d"], ref_m["g3d"], atol=3e-4, label="g3d")
        _assert_tree_close(dp_state.net3d.batch_stats,
                           ref_state.net3d.batch_stats, atol=1e-5,
                           label="bn3d")
