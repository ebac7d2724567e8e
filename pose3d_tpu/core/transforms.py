"""Pose-space transforms: flips, world->camera, zero-centring.

Behavioral contracts reproduced from the reference:
- ``flip_pose``: phase3_direct/my_HybrIK/utils.py:372-396 — horizontal flip;
  2D poses live in [0,1] image coords so x' = 1 - x, 3D poses are metric so
  x' = -x; left/right joints swap.
- world->camera: phase3_direct/my_HybrIK/H36_dataset.py:354-360 — subtract
  camera translation (converted mm->m) then rotate by the camera orientation
  quaternion.
- zero-centring: H36_dataset.py:209-211 + :286-289 — subtract the root joint
  from joints 1: and zero the root.

Design: all functions are pure jnp over arbitrary leading batch
axes (the reference loops per-frame in python); flips use a constant gather
permutation which XLA fuses into the surrounding computation.
"""

from __future__ import annotations

import jax.numpy as jnp

from pose3d_tpu.core.quaternion import qv_mult
from pose3d_tpu.core.skeleton import FLIP_PERMUTATION

_FLIP_PERM = jnp.asarray(FLIP_PERMUTATION)


def flip_pose(pose):
    """Horizontally flip (...,17,2) or (...,17,3) poses (utils.py:372-396)."""
    dim = pose.shape[-1]
    if dim == 2:
        x = 1.0 - pose[..., :1]
    elif dim == 3:
        x = -pose[..., :1]
    else:
        raise ValueError(f"expected last dim 2 or 3, got {dim}")
    flipped = jnp.concatenate([x, pose[..., 1:]], axis=-1)
    return jnp.take(flipped, _FLIP_PERM, axis=-2)


def world_to_camera(points, orientation, translation_mm):
    """World-frame (...,3) points -> camera frame (H36_dataset.py:354-360).

    ``orientation``: (...,4) scalar-first quaternion; ``translation_mm``:
    (...,3) camera position in millimetres (divided by 1000 exactly as the
    reference does). Broadcasts over leading axes.
    """
    shifted = points - translation_mm / 1000.0
    return qv_mult(orientation, shifted)


def zero_centre(pose):
    """Root-centre (...,17,D) poses: joints - root, root set to 0.

    Matches H36_dataset.py:209-211 (subtract root from joints 1:) combined
    with :286-289 (root *= 0).
    """
    centred = pose - pose[..., :1, :]
    return centred


def flip_heatmap(heatmap, pairs, shift: bool = False):
    """Horizontally flip (..., J, H, W) heatmaps and swap left/right joint
    channels (hybrik_utils.py:518-560 ``flip_heatmap``). ``shift`` rolls the
    flipped map right by one pixel (the reference's alignment correction)."""
    out = heatmap[..., ::-1]
    perm = list(range(heatmap.shape[-3]))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    out = jnp.take(out, jnp.asarray(perm), axis=-3)
    if shift:
        out = jnp.roll(out, 1, axis=-1)
    return out


def flip_xyz_joints(xyz, pairs):
    """Flip metric (..., J, 3) joints: negate x, swap pairs
    (hybrik_utils.py:648-686 ``flip_xyz_joints_3d``)."""
    out = xyz * jnp.asarray([-1.0, 1.0, 1.0], dtype=xyz.dtype)
    perm = list(range(xyz.shape[-2]))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return jnp.take(out, jnp.asarray(perm), axis=-2)


def flip_thetas(thetas, pairs):
    """Flip (..., J, 3) axis-angle rotations: negate the y/z components and
    swap left/right (hybrik_utils.py:991-1017 ``flip_thetas``)."""
    out = thetas * jnp.asarray([1.0, -1.0, -1.0], dtype=thetas.dtype)
    perm = list(range(thetas.shape[-2]))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return jnp.take(out, jnp.asarray(perm), axis=-2)


def flip_twist(phis, pairs):
    """Flip (..., 23, 2) twist (cos, sin): negate sin, swap pairs indexed
    relative to joint 1 (hybrik_utils.py:1020-1037 ``flip_twist``)."""
    out = phis * jnp.asarray([1.0, -1.0], dtype=phis.dtype)
    perm = list(range(phis.shape[-2]))
    for a, b in pairs:
        perm[a - 1], perm[b - 1] = perm[b - 1], perm[a - 1]
    return jnp.take(out, jnp.asarray(perm), axis=-2)


def camera_projection(points_cam, focal, center):
    """Pinhole projection of camera-frame (...,3) points to pixels.

    Not present in the reference (it uses precomputed 2D npz files); provided
    for the reprojection-consistency losses (phase5) and the video pipeline.
    ``focal``/``center``: (...,2).
    """
    xy = points_cam[..., :2] / jnp.clip(points_cam[..., 2:], 1e-6)
    return xy * focal + center
