"""Volumetric-heatmap pose heads: deconv stack + soft-argmax decode.

Reference contracts:
- deconv head (phase3_direct/my_HybrIK/Model.py:66-88): 3x
  ConvTranspose2d(kernel 4, stride 2, pad 1, no bias) 2048->256->256->256,
  each followed by BN + ReLU — upsamples the stride-32 8x8 feature map to
  64x64 — then a 1x1 conv to num_joints*depth channels (Model.py:45-46).
- ``PoseNet3D`` <- ``Model_3D`` (Model.py:12-191): ResNet-50 backbone ->
  deconv -> 64^3 volumetric softmax -> soft-argmax; returns the (B, 17*3)
  coordinate vector and the (B,17,64,64,64) normalized heatmap. z_scale is
  2.5 in phase3 (Model.py:177) and 2.0 in the phase4 variant
  (phase4_joined/Model.py:126-128) — a config knob here. The reference's
  dead camera-embedding MLP (Model.py:50-64,185-189) is commented-out code
  and not reproduced.
- ``PoseNet2D`` <- ``Model_2D`` (phase5_loop/Model_2d.py:13-138):
  depth_dim=1, 2D soft-argmax, coords in [0,1], output (B, 17*2).

NHWC throughout; ConvTranspose stride-2 SAME padding doubles the spatial
dims exactly like torch's (4,2,1) deconv; the softmax/soft-argmax decode is
one fused XLA computation (pose3d_tpu.ops.heatmap).
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn

from pose3d_tpu.models.norm import BatchNorm
import jax.numpy as jnp

from pose3d_tpu.models.resnet import ResNet, _bn
from pose3d_tpu.ops.heatmap import (
    soft_argmax_2d,
    soft_argmax_3d,
    soft_argmax_3d_nhwc,
)


class DeconvHead(nn.Module):
    """3x (ConvTranspose k4 s2 + BN + ReLU) + 1x1 projection."""

    filters: Sequence[int] = (256, 256, 256)
    out_channels: int = 17 * 64
    dropout: float = 0.0  # the reference's _make_deconv_layer_with_dropout variant
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool):
        for f in self.filters:
            x = nn.ConvTranspose(f, (4, 4), (2, 2), padding="SAME",
                                 use_bias=False, dtype=self.dtype)(x)
            x = _bn(train, self.dtype)(x)
            x = nn.relu(x)
            if self.dropout:
                x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return nn.Conv(self.out_channels, (1, 1), dtype=self.dtype)(x)


class PoseNet3D(nn.Module):
    """Direct image->3D regression (reference ``Model_3D``).

    (B, 256, 256, 3) NHWC float in [0,1] -> ((B, J*3) coords, (B,J,D,H,W)
    softmax heatmap). x,y in [-1,1]; z in [-z_scale, z_scale]/... per the
    reference rescale.
    """

    architecture: str = "resnet50"
    num_joints: int = 17
    depth: int = 64
    z_scale: float = 2.5
    return_heatmap: bool = True
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        feats = ResNet(self.architecture, dtype=self.dtype, name="backbone")(
            x, train=train
        )
        logits = DeconvHead(
            out_channels=self.num_joints * self.depth, dtype=self.dtype,
            name="head",
        )(feats, train=train)
        b, h, w, _ = logits.shape
        if not self.return_heatmap:
            # decode straight from NHWC: no layout transpose of the
            # (B,H,W,J*D) logits in forward or backward; XLA fuses the
            # softmax and the three weighted sums into the step
            coords = soft_argmax_3d_nhwc(
                logits, self.num_joints, self.depth, z_scale=self.z_scale,
            )
            return coords, None
        # heatmap requested: produce the reference's (B,J,D,H,W) volume
        logits = logits.transpose(0, 3, 1, 2).reshape(
            b, self.num_joints, self.depth, h, w
        )
        coords, heatmap = soft_argmax_3d(
            logits, self.num_joints, self.depth, h, w,
            z_scale=self.z_scale, return_heatmap=True,
        )
        return coords, heatmap


class PoseNet2D(nn.Module):
    """Image->2D keypoints (reference ``Model_2D``): (B,256,256,3) ->
    (B, J*2) coords in [0,1]."""

    architecture: str = "resnet50"
    num_joints: int = 17
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        feats = ResNet(self.architecture, dtype=self.dtype, name="backbone")(
            x, train=train
        )
        logits = DeconvHead(
            out_channels=self.num_joints, dtype=self.dtype, name="head"
        )(feats, train=train)
        b, h, w, _ = logits.shape
        logits = logits.transpose(0, 3, 1, 2)
        return soft_argmax_2d(logits, self.num_joints, h, w)


class ProjectionMLP(nn.Module):
    """3D->2D learned projection (reference ``Projection``,
    Model_2d.py:140-170): Flatten -> [Dense BN Tanh Dropout(.3)] x3
    (512/256/128) -> Dense(out). Superseded in the reference trainers by the
    ViT projector but kept for API parity."""

    in_dim: int = 51
    out_dim: int = 34
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        y = x.reshape(x.shape[0], -1).astype(self.dtype)
        for width in (512, 256, 128):
            y = nn.Dense(width, dtype=self.dtype)(y)
            y = BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, dtype=self.dtype)(y)
            y = nn.tanh(y)
            y = nn.Dropout(0.3, deterministic=not train)(y)
        y = nn.Dense(self.out_dim, dtype=self.dtype)(y)
        return y.astype(jnp.promote_types(self.dtype, jnp.float32))
