"""Checks that need the card (marker ``gpu``): run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. Elsewhere the
``gpu`` fixture skips them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.mark.gpu
def test_lifter_bf16_matches_f32_highest(gpu):
    """The flagship lifter at full width in bf16 against float32 at
    `highest` matmul precision (bf16 rounding through two blocks: ~1e-2 of
    the output scale)."""
    from pose3d_tpu.models.lifters import JointTransformerLifter

    x = jnp.asarray(np.random.default_rng(0).random((1024, 17, 2)),
                    jnp.float32)
    f32 = JointTransformerLifter()
    p = f32.init(jax.random.key(0), x)["params"]
    got = JointTransformerLifter(dtype=jnp.bfloat16).apply({"params": p}, x)
    with jax.default_matmul_precision("highest"):
        ref = f32.apply({"params": p}, x)
    err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
    assert err <= 3e-2


@pytest.mark.gpu
def test_donated_train_step_keeps_buffers_alive(gpu):
    """A donated temporal train step followed by host-side plateau updates
    (the trainer's loop): the learning rate must not leave the step as the
    same buffer twice, which the GPU runtime freed twice and aborted on."""
    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.train.schedule import plateau_update
    from pose3d_tpu.train.state import create_train_state
    from pose3d_tpu.train.steps import make_lifter_train_step

    model = TemporalLifter(clip_len=16, hidden=32, n_blocks=1, heads=2,
                           dtype=jnp.bfloat16)
    state = create_train_state(model, jax.random.key(0),
                               jnp.zeros((2, 16, 17, 2)), lr=1e-3)
    step = make_lifter_train_step()
    rng = np.random.default_rng(0)
    for i in range(6):
        y1 = jnp.asarray(rng.random((4, 16, 17, 2)), jnp.float32)
        y2 = jnp.asarray(rng.random((4, 16, 17, 3)), jnp.float32)
        state, m = step(state, y1, y2, jax.random.key(i))
        state = state.replace(plateau=plateau_update(state.plateau,
                                                     m["loss"]))
    assert np.isfinite(float(m["loss"]))
