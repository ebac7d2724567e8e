"""Compute ops: heatmap rendering and soft-argmax decoding in plain XLA."""

from pose3d_tpu.ops.heatmap import (  # noqa: F401
    gaussian_heatmap_3d,
    heatmap_targets,
    soft_argmax_2d,
    soft_argmax_3d,
    soft_argmax_3d_nhwc,
    uvw_to_xyz,
    xyz_to_uvw,
)
