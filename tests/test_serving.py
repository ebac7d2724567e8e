"""Serving: bucketed inference equals direct apply, arbitrary N handled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pose3d_tpu.models.lifters import JointTransformerLifter, MartinezLifter
from pose3d_tpu.serving import LifterService


@pytest.fixture(scope="module")
def vit_service():
    model = JointTransformerLifter(hidden=64, n_blocks=1, heads=2)
    params = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 17, 2)),
                        train=False)["params"]
    return model, params, LifterService(model, params, max_batch=128,
                                        min_bucket=32)


class TestLifterService:
    def test_matches_direct_apply(self, vit_service, rng):
        model, params, svc = vit_service
        kp2d = rng.random((50, 17, 2)).astype(np.float32)
        got = svc.lift(kp2d)
        want = np.asarray(
            model.apply({"params": params}, jnp.asarray(kp2d), train=False)
        )
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("n", [1, 32, 33, 128, 200])
    def test_arbitrary_sizes(self, vit_service, rng, n):
        _, _, svc = vit_service
        out = svc.lift(rng.random((n, 17, 2)).astype(np.float32))
        assert out.shape == (n, 17, 3)
        assert np.isfinite(out).all()

    def test_padding_does_not_leak(self, vit_service, rng):
        """Result for a 33-element request equals the first 33 of a 64-pad."""
        model, params, svc = vit_service
        kp2d = rng.random((33, 17, 2)).astype(np.float32)
        got = svc.lift(kp2d)
        np.testing.assert_allclose(got, svc.lift(kp2d.copy()), atol=0)
        want = np.asarray(
            model.apply({"params": params}, jnp.asarray(kp2d), train=False))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_martinez_with_batch_stats(self, rng):
        model = MartinezLifter()
        variables = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((2, 17, 2)), train=True,
        )
        svc = LifterService(model, variables["params"],
                            variables["batch_stats"], max_batch=64,
                            min_bucket=32)
        kp2d = rng.random((40, 17, 2)).astype(np.float32)
        got = svc.lift(kp2d)
        want = np.asarray(model.apply(variables, jnp.asarray(kp2d),
                                      train=False))
        np.testing.assert_allclose(got, want.reshape(40, 17, 3), atol=1e-5)

    def test_warmup(self, vit_service):
        _, _, svc = vit_service
        assert svc.warmup() is svc


class TestMeshServing:
    """DP serving over the 8-virtual-device mesh equals single-device."""

    def test_matches_single_device(self, devices, rng):
        from pose3d_tpu.parallel.mesh import make_mesh

        model = JointTransformerLifter(hidden=64, n_blocks=1, heads=2)
        params = model.init({"params": jax.random.key(0)},
                            jnp.zeros((1, 17, 2)), train=False)["params"]
        mesh = make_mesh()  # all 8 devices on the data axis
        svc_mesh = LifterService(model, params, max_batch=128,
                                 min_bucket=32, mesh=mesh)
        svc_one = LifterService(model, params, max_batch=128, min_bucket=32)
        assert all(b % 8 == 0 for b in svc_mesh.buckets)
        kp2d = rng.random((77, 17, 2)).astype(np.float32)  # odd N -> pad
        np.testing.assert_allclose(svc_mesh.lift(kp2d), svc_one.lift(kp2d),
                                   atol=1e-6)

    def test_martinez_mesh_with_batch_stats(self, devices, rng):
        from pose3d_tpu.parallel.mesh import make_mesh

        model = MartinezLifter()
        variables = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((2, 17, 2)), train=True,
        )
        svc = LifterService(model, variables["params"],
                            variables["batch_stats"], max_batch=64,
                            min_bucket=16, mesh=make_mesh())
        kp2d = rng.random((40, 17, 2)).astype(np.float32)
        want = np.asarray(model.apply(variables, jnp.asarray(kp2d),
                                      train=False))
        np.testing.assert_allclose(svc.lift(kp2d), want.reshape(40, 17, 3),
                                   atol=1e-5)
