"""Numerical parity vs the ACTUAL reference torch modules, by weight
transplant.

Each test builds the reference torch model (imported from /root/reference),
randomizes its BatchNorm running statistics so running-stat transplant is
actually exercised, copies its state dict into this framework's flax params
via pose3d_tpu.interop, and asserts forward equality on random inputs.

Covered:
- ``LinearModel``  -> MartinezLifter   (phase1_lifting/baselineModel.py:50-102)
- ``MyViT``        -> JointTransformerLifter (baselineModel.py:312-362)
- ``AE``           -> AELifter          (baselineModel.py:135-215)
- sinusoidal PE table                   (baselineModel.py:220-225)
- ``ResNet`` 50 feature maps            (phase3_direct/my_HybrIK/Resnet.py:98-165)
- ``Model_3D`` coords + heatmap         (Model.py:118-191, incl. soft-argmax)
- ``Model_2D`` coords                   (phase5_loop/Model_2d.py:13-138)
- ``Projection``   -> ProjectionMLP     (Model_2d.py:140-170)

The reference models need torchvision for their ImageNet warm start
(Model.py:30-38); this image has none, so a stub returning a fresh
reference-format ResNet is installed — the state-dict surgery then merges
random (but transplantable) weights, which is exactly what parity needs.
"""

from __future__ import annotations

import importlib
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pose3d_tpu.interop import (  # noqa: E402
    ae_from_torch,
    martinez_from_torch,
    posenet2d_from_torch,
    posenet3d_from_torch,
    projection_from_torch,
    resnet_from_torch,
    vit_lifter_from_torch,
)
from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D, ProjectionMLP  # noqa: E402
from pose3d_tpu.models.lifters import (  # noqa: E402
    AELifter,
    JointTransformerLifter,
    MartinezLifter,
    sinusoidal_positional_embeddings,
)
from pose3d_tpu.models.resnet import ResNet  # noqa: E402

REF = pathlib.Path("/root/reference")
PHASE1 = REF / "phase1_lifting"
PHASE3 = REF / "phase3_direct" / "my_HybrIK"
PHASE5 = REF / "phase5_loop"

pytestmark = pytest.mark.skipif(
    not PHASE1.exists(), reason="reference checkout not present"
)


def _install_torchvision_stub():
    """Model_3D/Model_2D do ``import torchvision.models`` for the ImageNet
    warm start; return a fresh reference ResNet so the surgery is a no-op
    merge of same-format random weights."""
    if "torchvision" in sys.modules:
        return
    tv = types.ModuleType("torchvision")
    tvm = types.ModuleType("torchvision.models")

    def resnet50(pretrained=False, **kw):
        ref_resnet = ref_module("Resnet", PHASE3)
        return ref_resnet.ResNet("resnet50")

    tvm.resnet50 = resnet50
    tvm.resnet101 = lambda pretrained=False, **kw: ref_module(
        "Resnet", PHASE3
    ).ResNet("resnet101")
    tv.models = tvm
    sys.modules["torchvision"] = tv
    sys.modules["torchvision.models"] = tvm


_cache: dict = {}


def ref_module(name: str, *paths: pathlib.Path):
    """Import a reference module by name with the given dirs on sys.path."""
    if name in _cache:
        return _cache[name]
    _install_torchvision_stub()
    add = [str(p) for p in (*paths, PHASE3)]  # phase3 for cross-phase imports
    for p in add:
        if p not in sys.path:
            sys.path.append(p)
    try:
        mod = importlib.import_module(name)
    finally:
        for p in add:
            if p in sys.path:
                sys.path.remove(p)
    _cache[name] = mod
    return mod


def randomize_bn_stats(model: "torch.nn.Module", seed: int = 0):
    """Give every BatchNorm non-trivial running statistics so the transplant
    of batch_stats is actually tested (fresh stats are mean 0 / var 1)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g) * 0.2)
            m.running_var.copy_(
                torch.rand(m.running_var.shape, generator=g) + 0.5
            )


def sd(model):
    return model.state_dict()


# ---------------------------------------------------------------- lifters


def test_positional_embedding_table_matches_reference():
    bm = ref_module("baselineModel", PHASE1)
    ref = bm.get_positional_embeddings(17, 256).numpy()
    ours = sinusoidal_positional_embeddings(17, 256)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_martinez_transplant_forward_parity():
    bm = ref_module("baselineModel", PHASE1)
    torch.manual_seed(0)
    tmodel = bm.LinearModel(i_dim=34, o_dim=51)
    randomize_bn_stats(tmodel)
    tmodel.eval()

    x = np.random.default_rng(0).standard_normal((8, 17, 2)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x)).numpy()

    variables = martinez_from_torch(sd(tmodel))
    y = MartinezLifter().apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)


def test_vit_lifter_transplant_forward_parity():
    bm = ref_module("baselineModel", PHASE1)
    torch.manual_seed(1)
    tmodel = bm.MyViT(chw=(1, 17, 2), out_d=3)
    tmodel.eval()

    x = np.random.default_rng(1).standard_normal((8, 17, 2)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x)).numpy()

    variables = vit_lifter_from_torch(sd(tmodel))
    y = JointTransformerLifter().apply(variables, jnp.asarray(x), train=False)
    assert y.shape == (8, 17, 3) == y_ref.shape
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)


def test_vit_projector_transplant_forward_parity():
    """The phase5 projector is MyViT(chw=(1,17,3), out_d=2) (train_5.py:63)."""
    bm = ref_module("baselineModel", PHASE1)
    torch.manual_seed(2)
    tmodel = bm.MyViT(chw=(1, 17, 3), out_d=2)
    tmodel.eval()

    x = np.random.default_rng(2).standard_normal((4, 17, 3)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x)).numpy()

    variables = vit_lifter_from_torch(sd(tmodel))
    y = JointTransformerLifter(in_dim=3, out_dim=2).apply(
        variables, jnp.asarray(x), train=False
    )
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)


def test_ae_transplant_forward_parity():
    bm = ref_module("baselineModel", PHASE1)
    torch.manual_seed(3)
    tmodel = bm.AE(input_dim=2, output_dim=3)
    randomize_bn_stats(tmodel, seed=3)
    tmodel.eval()

    x = np.random.default_rng(3).standard_normal((8, 17, 2)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x).reshape(8, -1)).numpy()

    variables = ae_from_torch(sd(tmodel))
    y = AELifter().apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)


def test_ae_2d_output_no_tanh():
    """The reference AE's final Tanh (baselineModel.py:208,213-214) is dead
    code: the guard tests ``self.output_dim == 2`` AFTER ``output_dim`` was
    multiplied by n_joints (34 != 2), so even the 2D-output config returns
    unbounded values. The rebuild matches the actual behavior."""
    bm = ref_module("baselineModel", PHASE1)
    torch.manual_seed(4)
    tmodel = bm.AE(input_dim=3, output_dim=2)
    randomize_bn_stats(tmodel, seed=4)
    with torch.no_grad():
        # force |output| >> 1: a Tanh would clamp this to (-1, 1)
        tmodel.decoder2[4].bias.fill_(5.0)
    tmodel.eval()

    x = np.random.default_rng(4).standard_normal((4, 17, 3)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x).reshape(4, -1)).numpy()
    assert np.abs(y_ref).max() > 1.0  # tanh did NOT fire (reference bug)

    variables = ae_from_torch(sd(tmodel))
    y = AELifter(in_dim=51, out_dim=34).apply(
        variables, jnp.asarray(x), train=False
    )
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)


# ---------------------------------------------------------------- image path


def _rel_close(ours, ref, rtol=5e-4):
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(ours, ref, atol=rtol * scale, rtol=0)


def test_resnet50_feature_parity():
    ref_resnet = ref_module("Resnet", PHASE3)
    torch.manual_seed(5)
    tmodel = ref_resnet.ResNet("resnet50")
    randomize_bn_stats(tmodel, seed=5)
    tmodel.eval()

    x = np.random.default_rng(5).standard_normal((2, 3, 64, 64)).astype(
        np.float32
    )
    with torch.no_grad():
        feats_ref = tmodel(torch.from_numpy(x)).numpy()  # (2, 2048, 2, 2)

    model = ResNet("resnet50")
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = model.init(jax.random.PRNGKey(0), x_nhwc, train=False)
    variables, n = resnet_from_torch(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]},
        sd(tmodel),
    )
    # every torch tensor must land (numel check: surgery merged all of it)
    n_torch = sum(1 for k in sd(tmodel) if "num_batches_tracked" not in k)
    assert n == n_torch, f"merged {n} of {n_torch} reference tensors"

    feats = model.apply(variables, x_nhwc, train=False)
    _rel_close(np.asarray(feats).transpose(0, 3, 1, 2), feats_ref)


def test_model3d_transplant_full_forward_parity():
    """Full Model_3D vs PoseNet3D: backbone + deconv + 1x1 + 64^3 softmax +
    soft-argmax decode (Model.py:118-191), coords AND heatmap."""
    ref_model = ref_module("Model", PHASE3)
    torch.manual_seed(6)
    tmodel = ref_model.Model_3D()
    randomize_bn_stats(tmodel, seed=6)
    tmodel.eval()

    # Model_3D hardcodes the 64^3 reshape (Model.py:146) => 256^2 input only
    x = np.random.default_rng(6).standard_normal((1, 3, 256, 256)).astype(
        np.float32
    )
    with torch.no_grad():
        coords_ref, hm_ref = tmodel(torch.from_numpy(x), torch.zeros(1, 2))
    coords_ref, hm_ref = coords_ref.numpy(), hm_ref.numpy()

    model = PoseNet3D(depth=64, z_scale=2.5, return_heatmap=True)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    init = model.init(jax.random.PRNGKey(0), x_nhwc, train=False)
    variables, _ = posenet3d_from_torch(init, sd(tmodel))
    coords, hm = model.apply(variables, x_nhwc, train=False)

    assert hm.shape == hm_ref.shape == (1, 17, 64, 64, 64)
    _rel_close(np.asarray(hm), hm_ref, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(coords), coords_ref, atol=5e-4)


def test_model2d_transplant_full_forward_parity():
    ref_m2d = ref_module("Model_2d", PHASE5)
    torch.manual_seed(7)
    tmodel = ref_m2d.Model_2D()
    randomize_bn_stats(tmodel, seed=7)
    tmodel.eval()

    # Model_2D hardcodes 64x64 maps (Model_2d.py:104) => 256^2 input only
    x = np.random.default_rng(7).standard_normal((1, 3, 256, 256)).astype(
        np.float32
    )
    with torch.no_grad():
        coords_ref = tmodel(torch.from_numpy(x)).numpy()  # (1, 34), [0,1]

    model = PoseNet2D()
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    init = model.init(jax.random.PRNGKey(0), x_nhwc, train=False)
    variables, _ = posenet2d_from_torch(init, sd(tmodel))
    coords = model.apply(variables, x_nhwc, train=False)
    np.testing.assert_allclose(np.asarray(coords), coords_ref, atol=5e-4)


def test_projection_mlp_transplant_parity():
    ref_m2d = ref_module("Model_2d", PHASE5)
    torch.manual_seed(8)
    tmodel = ref_m2d.Projection(input_dim=3, output_dim=2)
    randomize_bn_stats(tmodel, seed=8)
    tmodel.eval()

    x = np.random.default_rng(8).standard_normal((6, 17, 3)).astype(np.float32)
    with torch.no_grad():
        y_ref = tmodel(torch.from_numpy(x)).numpy()

    variables = projection_from_torch(sd(tmodel))
    y = ProjectionMLP(in_dim=51, out_dim=34).apply(
        variables, jnp.asarray(x), train=False
    )
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-5)
