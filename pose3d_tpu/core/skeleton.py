"""H36M 17-joint skeleton constants and the COCO->H36M joint remap.

Behavioral contracts reproduced from the reference:
- joint selection from the raw 32-joint H36M export:
  phase3_direct/my_HybrIK/H36_dataset.py:48 (``KeyPoints_from3d``)
- bone list used for rendering: phase3_direct/my_HybrIK/utils.py:37 (``sk_points``)
- left/right joint pairs for horizontal flips:
  phase3_direct/my_HybrIK/utils.py:382-383 (``flip_pose``)
- COCO->H36M remap with synthesized root/belly/neck/head midpoints:
  phase2_opp_mb/run.py:15-58 (``coco2h36m``)

Design: the COCO->H36M remap is expressed as a constant (17,17)
mixing matrix so a whole clip remaps as one einsum (vmap/jit friendly, a
matrix-unit op for large batches) instead of the reference's per-row numpy assignment.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17

# Indices into the raw 32-joint Human3.6M export that make up the canonical
# 17-joint skeleton (H36_dataset.py:48).
H36M_KEYPOINTS_FROM_32 = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)

# Canonical joint names, index-aligned with the 17-joint skeleton
# (ordering documented in phase2_opp_mb/run.py:21-38).
JOINT_NAMES = (
    "root", "rhip", "rkne", "rank", "lhip", "lkne", "lank", "belly",
    "neck", "nose", "head", "lsho", "lelb", "lwri", "rsho", "relb", "rwri",
)

# Bone segments for rendering (utils.py:37). Kept verbatim including the
# duplicated [5,6] edge so renders match the reference pixel-for-pixel.
BONES = (
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (5, 6), (0, 7), (7, 8),
    (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15), (15, 16),
)

# Left/right pairs used by horizontal pose flips (utils.py:382-383).
LEFT_JOINTS = (4, 5, 6, 11, 12, 13)
RIGHT_JOINTS = (1, 2, 3, 14, 15, 16)

# Permutation that swaps left<->right joints; identity elsewhere.
FLIP_PERMUTATION = tuple(
    dict(zip(LEFT_JOINTS + RIGHT_JOINTS, RIGHT_JOINTS + LEFT_JOINTS)).get(j, j)
    for j in range(NUM_JOINTS)
)

# COCO joint ordering: 0-nose 1-Leye 2-Reye 3-Lear 4-Rear 5-Lsho 6-Rsho
# 7-Lelb 8-Relb 9-Lwri 10-Rwri 11-Lhip 12-Rhip 13-Lkne 14-Rkne 15-Lank 16-Rank


def _build_coco_to_h36m_matrix() -> np.ndarray:
    """(17,17) matrix M with h36m = M @ coco (same semantics as run.py:15-58).

    Note the reference leaves no COCO joint mapped to H36M index 7 directly;
    belly = 0.5*(root + neck) which expands to quarter-weights on the four
    shoulder/hip joints.
    """
    m = np.zeros((NUM_JOINTS, NUM_JOINTS), dtype=np.float64)
    m[0, 11] = m[0, 12] = 0.5          # root   = (Lhip + Rhip)/2
    m[1, 12] = 1.0                     # rhip
    m[2, 14] = 1.0                     # rkne
    m[3, 16] = 1.0                     # rank
    m[4, 11] = 1.0                     # lhip
    m[5, 13] = 1.0                     # lkne
    m[6, 15] = 1.0                     # lank
    m[8, 5] = m[8, 6] = 0.5            # neck   = (Lsho + Rsho)/2
    m[7] = 0.5 * (m[0] + m[8])         # belly  = (root + neck)/2
    m[9, 0] = 1.0                      # nose
    m[10, 1] = m[10, 2] = 0.5          # head   = (Leye + Reye)/2
    m[11, 5] = 1.0                     # lsho
    m[12, 7] = 1.0                     # lelb
    m[13, 9] = 1.0                     # lwri
    m[14, 6] = 1.0                     # rsho
    m[15, 8] = 1.0                     # relb
    m[16, 10] = 1.0                    # rwri
    return m


COCO_TO_H36M_MATRIX = _build_coco_to_h36m_matrix()


# Kinematic z-recovery ancestor chains (hybrik_utils.py:1181-1208,
# ``h36m_recover_z``): for each non-root joint, the bone indices (joint-1
# relative) along its path to the root — used to reconstruct absolute depth
# from per-bone relative depths. Kept for API parity with decode pipelines
# that consume it.
H36M_RECOVER_Z = (
    None, (0,), (1, 0), (2, 1, 0),
    (3,), (4, 3), (5, 4, 3),
    (6,), (7, 6),
    (8, 7, 6), (9, 8, 7, 6),
    (10, 6), (11, 10, 6), (12, 11, 10, 6),
    (13, 6), (14, 13, 6), (15, 14, 13, 6),
    (16, 6),
)


def coco_to_h36m(x):
    """Remap COCO-ordered keypoints to H36M ordering.

    Accepts any array of shape (..., 17, C); the remap applies over the joint
    axis. Works on numpy or jax arrays (pure matmul — jit/vmap friendly).
    Matches phase2_opp_mb/run.py:15-58 exactly (y = M @ x per frame).
    """
    if isinstance(x, np.ndarray):
        return COCO_TO_H36M_MATRIX.astype(x.dtype) @ x
    import jax
    import jax.numpy as jnp

    # HIGHEST precision: keypoint coordinates must not round through bf16
    # or TF32 — this matmul is a remap, not a compute hot spot.
    return jnp.matmul(
        jnp.asarray(COCO_TO_H36M_MATRIX, dtype=x.dtype),
        x,
        precision=jax.lax.Precision.HIGHEST,
    )
