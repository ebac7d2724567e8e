"""flax -> torch-format export round-trips through the proven importers.

The ``*_from_torch`` importers are validated against the live reference by
weight-transplant forward-equality tests (tests/test_reference_parity.py);
these tests prove the new ``*_to_torch`` exporters are their exact
inverses, making checkpoint interop bidirectional.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.interop import torch_weights as tw


def _trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), atol=0,
                err_msg=f"{path}/{k}")


def _randomize(variables, rng):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        variables)


def test_martinez_roundtrip(rng):
    from pose3d_tpu.models.lifters import MartinezLifter

    m = MartinezLifter()
    v = _randomize(m.init(jax.random.key(0), jnp.zeros((2, 17, 2)),
                          train=False), rng)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tw.martinez_to_torch(v)
    back = tw.martinez_from_torch(sd)
    _trees_equal(v["params"], back["params"])
    _trees_equal(v["batch_stats"], back["batch_stats"])


def test_ae_roundtrip(rng):
    from pose3d_tpu.models.lifters import AELifter

    m = AELifter()
    v = _randomize(m.init(jax.random.key(0), jnp.zeros((2, 17, 2)),
                          train=False), rng)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tw.ae_to_torch(v)
    back = tw.ae_from_torch(sd)
    _trees_equal(v["params"], back["params"])
    _trees_equal(v["batch_stats"], back["batch_stats"])


def test_vit_lifter_roundtrip(rng):
    from pose3d_tpu.models.lifters import JointTransformerLifter

    m = JointTransformerLifter()
    v = _randomize(m.init({"params": jax.random.key(0)},
                          jnp.zeros((2, 17, 2)), train=False), rng)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tw.vit_lifter_to_torch(v)
    back = tw.vit_lifter_from_torch(sd)
    _trees_equal(v["params"], back["params"])


def test_projection_roundtrip(rng):
    from pose3d_tpu.models.heads import ProjectionMLP

    m = ProjectionMLP()
    v = _randomize(m.init(jax.random.key(0), jnp.zeros((2, 51)),
                          train=False), rng)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tw.projection_to_torch(v)
    back = tw.projection_from_torch(sd)
    _trees_equal(v["params"], back["params"])
    _trees_equal(v["batch_stats"], back["batch_stats"])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_posenet3d_roundtrip(rng, arch):
    from pose3d_tpu.models.heads import PoseNet3D

    m = PoseNet3D(architecture=arch, return_heatmap=False)
    v = _randomize(
        jax.jit(lambda r, x: m.init(r, x, train=False))(
            jax.random.key(0), jnp.zeros((1, 64, 64, 3))), rng)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tw.posenet3d_to_torch(v)
    back, n = tw.posenet3d_from_torch(v, sd)
    assert n > 0
    _trees_equal(v["params"], back["params"])
    _trees_equal(v["batch_stats"], back["batch_stats"])
