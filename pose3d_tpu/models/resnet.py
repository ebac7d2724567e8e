"""ResNet backbones (18/34/50/101/152), NHWC, stride-32 feature output.

Architectural contract from the reference (phase3_direct/my_HybrIK/Resnet.py,
byte-identical copy in phase4_joined): stem conv7x7 s2 + maxpool3x3 s2, four
stages of BasicBlock (18/34) or Bottleneck (50/101/152), BN momentum 0.1
(torch) = 0.9 (flax), eps 1e-5, no classification head — the backbone returns
the (H/32, W/32, 2048|512) feature map consumed by the deconv head. The
reference's unused DCN hooks (Resnet.py:74-84) are dead code and not
reproduced.

NHWC layout (the reference is NCHW; cuDNN takes NHWC for bf16 convolutions), compute dtype configurable for bf16 throughput, BatchNorm statistics
are global under data-parallel jit via GSPMD.

ImageNet warm-start: the reference state-dict surgery (Model.py:30-38) maps
to :func:`load_torch_resnet` — a converter from a torch-format ResNet state
dict (numpy values) into flax params, for environments where the torchvision
checkpoint exists locally (this image has no torchvision / no egress).
"""

from __future__ import annotations

import flax.linen as nn

from pose3d_tpu.models.norm import BatchNorm
import jax.numpy as jnp
import numpy as np

STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
BOTTLENECK_ARCHS = ("resnet50", "resnet101", "resnet152")


def _bn(train: bool, dtype, name=None):
    return BatchNorm(
        use_running_average=not train, momentum=0.9, epsilon=1e-5,
        dtype=dtype, name=name,
    )


class BasicBlock(nn.Module):
    planes: int
    stride: int = 1
    downsample: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool):
        identity = x
        y = nn.Conv(self.planes, (3, 3), (self.stride, self.stride),
                    padding=1, use_bias=False, dtype=self.dtype)(x)
        y = _bn(train, self.dtype)(y)
        y = nn.relu(y)
        y = nn.Conv(self.planes, (3, 3), padding=1, use_bias=False,
                    dtype=self.dtype)(y)
        y = _bn(train, self.dtype)(y)
        if self.downsample:
            identity = nn.Conv(self.planes, (1, 1),
                               (self.stride, self.stride), use_bias=False,
                               dtype=self.dtype)(x)
            identity = _bn(train, self.dtype)(identity)
        return nn.relu(y + identity)


class Bottleneck(nn.Module):
    planes: int
    stride: int = 1
    downsample: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool):
        identity = x
        y = nn.Conv(self.planes, (1, 1), use_bias=False, dtype=self.dtype)(x)
        y = _bn(train, self.dtype)(y)
        y = nn.relu(y)
        y = nn.Conv(self.planes, (3, 3), (self.stride, self.stride),
                    padding=1, use_bias=False, dtype=self.dtype)(y)
        y = _bn(train, self.dtype)(y)
        y = nn.relu(y)
        y = nn.Conv(self.planes * 4, (1, 1), use_bias=False, dtype=self.dtype)(y)
        y = _bn(train, self.dtype)(y)
        if self.downsample:
            identity = nn.Conv(self.planes * 4, (1, 1),
                               (self.stride, self.stride), use_bias=False,
                               dtype=self.dtype)(x)
            identity = _bn(train, self.dtype)(identity)
        return nn.relu(y + identity)


class ResNet(nn.Module):
    """Backbone: (B, H, W, 3) -> (B, H/32, W/32, C_out)."""

    architecture: str = "resnet50"
    dtype: jnp.dtype = jnp.float32

    @property
    def feature_channels(self) -> int:
        return 2048 if self.architecture in BOTTLENECK_ARCHS else 512

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        blocks = STAGE_BLOCKS[self.architecture]
        bottleneck = self.architecture in BOTTLENECK_ARCHS
        block_cls = Bottleneck if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1

        x = x.astype(self.dtype)
        x = nn.Conv(64, (7, 7), (2, 2), padding=3, use_bias=False,
                    dtype=self.dtype, name="stem_conv")(x)
        x = _bn(train, self.dtype, name="stem_bn")(x)
        x = nn.relu(x)
        x = nn.max_pool(x, (3, 3), (2, 2), padding=((1, 1), (1, 1)))

        in_planes = 64
        for stage, n_blocks in enumerate(blocks):
            planes = 64 * (2 ** stage)
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or in_planes != planes * expansion)
                x = block_cls(planes, s, down, dtype=self.dtype,
                              name=f"stage{stage + 1}_block{b}")(x, train=train)
                in_planes = planes * expansion
        return x


def load_torch_resnet(flax_params, flax_batch_stats, state_dict):
    """Merge a torch-format ResNet state dict into flax param/stat trees.

    Reproduces the reference's warm-start-by-filtered-merge semantics
    (Model.py:30-38): any torch entry whose mapped flax leaf exists with a
    matching (transposed) shape is copied; everything else is left at its
    fresh initialization. ``state_dict``: {torch_key: numpy array}.
    Returns (params, batch_stats, n_loaded).
    """
    import flax

    params = flax.core.unfreeze(flax_params)
    stats = flax.core.unfreeze(flax_batch_stats)
    n = 0

    def put(tree, path, value):
        nonlocal n
        node = tree
        for k in path[:-1]:
            if k not in node:
                return False
            node = node[k]
        leaf = node.get(path[-1])
        if leaf is not None and leaf.shape == value.shape:
            node[path[-1]] = jnp.asarray(value, leaf.dtype)
            n += 1
            return True
        return False

    def conv_w(v):  # torch OIHW -> flax HWIO
        return np.transpose(v, (2, 3, 1, 0))

    stage_map = {"layer1": "stage1", "layer2": "stage2",
                 "layer3": "stage3", "layer4": "stage4"}

    for key, value in state_dict.items():
        value = np.asarray(value)
        parts = key.split(".")
        if key == "conv1.weight":
            put(params, ("stem_conv", "kernel"), conv_w(value))
        elif parts[0] == "bn1":
            tgt = {"weight": ("stem_bn", "scale"), "bias": ("stem_bn", "bias")}
            stt = {"running_mean": ("stem_bn", "mean"),
                   "running_var": ("stem_bn", "var")}
            if parts[1] in tgt:
                put(params, tgt[parts[1]], value)
            elif parts[1] in stt:
                put(stats, stt[parts[1]], value)
        elif parts[0] in stage_map:
            block = f"{stage_map[parts[0]]}_block{parts[1]}"
            rest = parts[2:]
            # conv1/2/3 -> Conv_0/1/2; bn1/2/3 -> BatchNorm_0/1/2;
            # downsample.0 -> Conv_3 (or _2 for BasicBlock), downsample.1 -> BN
            if rest[0].startswith("conv"):
                idx = int(rest[0][-1]) - 1
                put(params, (block, f"Conv_{idx}", "kernel"), conv_w(value))
            elif rest[0].startswith("bn"):
                idx = int(rest[0][-1]) - 1
                if rest[1] == "weight":
                    put(params, (block, f"BatchNorm_{idx}", "scale"), value)
                elif rest[1] == "bias":
                    put(params, (block, f"BatchNorm_{idx}", "bias"), value)
                elif rest[1] == "running_mean":
                    put(stats, (block, f"BatchNorm_{idx}", "mean"), value)
                elif rest[1] == "running_var":
                    put(stats, (block, f"BatchNorm_{idx}", "var"), value)
            elif rest[0] == "downsample":
                # The downsample conv/BN are the last-numbered modules in the
                # block: Conv_3/BatchNorm_3 for Bottleneck (main path 0..2),
                # Conv_2/BatchNorm_2 for BasicBlock (main path 0..1). Try the
                # Bottleneck slot first; stop at the first shape-true merge.
                bn_idx = {"weight": "scale", "bias": "bias"}
                bs_idx = {"running_mean": "mean", "running_var": "var"}
                for i in (3, 2):
                    if rest[1] == "0" and rest[2] == "weight":
                        if put(params, (block, f"Conv_{i}", "kernel"),
                               conv_w(value)):
                            break
                    elif rest[1] == "1" and rest[2] in bn_idx:
                        if put(params, (block, f"BatchNorm_{i}",
                                        bn_idx[rest[2]]), value):
                            break
                    elif rest[1] == "1" and rest[2] in bs_idx:
                        if put(stats, (block, f"BatchNorm_{i}",
                                       bs_idx[rest[2]]), value):
                            break
    return flax.core.freeze(params), flax.core.freeze(stats), n
