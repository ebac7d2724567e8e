"""Synthetic Human3.6M-like data for tests, CI, and benchmarks.

The reference requires the (non-redistributable) H36M npz export
(H36_dataset.py:41-43). This module produces kinematically plausible random
skeletons with the same shapes/conventions so every pipeline stage can run
hermetically: 3D poses in camera space (metres, root near 2.5-5.5 m depth),
2D poses as pinhole projections into [0,1]^2 image coordinates — matching the
value ranges the reference's loaders produce.
"""

from __future__ import annotations

import numpy as np

from pose3d_tpu.core import cameras
from pose3d_tpu.core.skeleton import NUM_JOINTS

# Average H36M bone offsets (metres) from the root, per joint, eyeballed from
# the canonical rest skeleton — enough realism for shape/range parity.
_REST_POSE = np.array(
    [
        [0.0, 0.0, 0.0],       # root
        [-0.13, 0.0, 0.0],     # rhip
        [-0.14, 0.0, -0.45],   # rkne
        [-0.15, 0.0, -0.90],   # rank
        [0.13, 0.0, 0.0],      # lhip
        [0.14, 0.0, -0.45],    # lkne
        [0.15, 0.0, -0.90],    # lank
        [0.0, 0.02, 0.25],     # belly
        [0.0, 0.03, 0.50],     # neck
        [0.0, 0.08, 0.60],     # nose
        [0.0, 0.04, 0.70],     # head
        [0.15, 0.0, 0.47],     # lsho
        [0.30, 0.02, 0.28],    # lelb
        [0.42, 0.05, 0.10],    # lwri
        [-0.15, 0.0, 0.47],    # rsho
        [-0.30, 0.02, 0.28],   # relb
        [-0.42, 0.05, 0.10],   # rwri
    ],
    dtype=np.float32,
)


def synthetic_poses_3d(n_frames: int, seed: int = 0, jitter: float = 0.05):
    """(N,17,3) float32 camera-frame poses: rest pose + smooth noise + depth."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=jitter, size=(n_frames, NUM_JOINTS, 3)).astype(np.float32)
    root = np.zeros((n_frames, 1, 3), dtype=np.float32)
    root[:, 0, 0] = rng.uniform(-0.5, 0.5, n_frames)
    root[:, 0, 1] = rng.uniform(-0.3, 0.3, n_frames)
    root[:, 0, 2] = rng.uniform(2.5, 5.5, n_frames)
    # camera frame: x right, y down, z forward — rest pose's "up" axis mapped to -y
    pose = _REST_POSE[None].copy()
    pose = np.stack([pose[..., 0], -pose[..., 2], pose[..., 1]], axis=-1)
    return (pose + noise + root).astype(np.float32)


def project_to_2d(poses_3d: np.ndarray, camera: int = 0):
    """Pinhole-project (N,17,3) camera-frame poses to (N,17,2) in [0,1] coords.

    Uses the real H36M intrinsics and divides by the 1000-px image size, the
    same convention as the reference's 2D npz (pixels/1000 ~ [0,1]).
    """
    f = cameras.FOCAL_LENGTH[camera]
    c = cameras.CENTER[camera]
    xy = poses_3d[..., :2] / np.clip(poses_3d[..., 2:], 1e-6, None)
    px = xy * f + c
    return (px / 1000.0).astype(np.float32)


def synthetic_h36m(n_frames: int, seed: int = 0):
    """(kp2d (N,17,2) in [0,1], kp3d (N,17,3) metres) mimicking read_data output."""
    kp3d = synthetic_poses_3d(n_frames, seed=seed)
    kp2d = project_to_2d(kp3d, camera=seed % 4)
    return kp2d, kp3d


def synthetic_frames(n_frames: int, size: int = 256, seed: int = 0):
    """(N,size,size,3) float32 in [0,1) mimicking the resized/normalized frames
    the reference produces at H36_dataset.py:129-131 (resize 256, /256)."""
    rng = np.random.default_rng(seed)
    return rng.random((n_frames, size, size, 3), dtype=np.float32)


# ---------------------------------------------------------------------------
# On-device skeleton rendering: pixels a detector can actually learn from
# ---------------------------------------------------------------------------

# Deterministic per-joint palette (17,3) in [0.35,1): distinct colors give
# the detector an unambiguous left/right signal, like markered mocap suits.
_JOINT_COLORS = np.random.default_rng(7).uniform(0.35, 1.0, (NUM_JOINTS, 3)) \
    .astype(np.float32)
_BONE_POINTS = 6  # interior gaussian samples per bone segment


def render_pose_frames(kp2d, key, size: int = 256, sigma: float = 2.5,
                       noise: float = 0.12):
    """Render (B,17,2) [0,1] keypoints into (B,size,size,3) skeleton frames.

    On-device replacement for a real camera: every joint is a separable
    2D gaussian blob in its palette color and every bone a chain of
    interior blobs, composited with ONE einsum (the on-device target-
    synthesis trick from ops/heatmap.py applied to RGB), plus uniform
    background noise. Runs inside jit at training time, so the detector
    trainer (cli/train_detector.py) needs only (B,17,2) on the wire —
    the analogue of the reference's phase-5 image pathway
    (phase5_loop/Model_2d.py:13-138) with frames the CI can synthesize.
    """
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.core.skeleton import BONES

    kp = jnp.asarray(kp2d, jnp.float32)
    b = kp.shape[0]
    a_idx = jnp.asarray([e[0] for e in BONES])
    b_idx = jnp.asarray([e[1] for e in BONES])
    # interior points of each bone: (B, n_bones*K, 2)
    ts = jnp.linspace(0.0, 1.0, _BONE_POINTS + 2)[1:-1]
    pa, pb = kp[:, a_idx], kp[:, b_idx]
    bone_pts = pa[:, :, None] + ts[None, None, :, None] * \
        (pb - pa)[:, :, None]
    bone_pts = bone_pts.reshape(b, -1, 2)

    colors = jnp.asarray(_JOINT_COLORS)
    bone_col = 0.4 * (colors[a_idx] + colors[b_idx]) / 2.0
    bone_col = jnp.repeat(bone_col, _BONE_POINTS, axis=0)

    pts = jnp.concatenate([kp, bone_pts], axis=1) * size   # pixel coords
    cols = jnp.concatenate([colors, bone_col], axis=0)     # (P, 3)
    widths = jnp.concatenate([
        jnp.full((kp.shape[1],), sigma),
        jnp.full((bone_pts.shape[1],), sigma * 0.7),
    ])

    grid = jnp.arange(size, dtype=jnp.float32) + 0.5
    gx = jnp.exp(-0.5 * ((grid[None, None] - pts[..., :1])
                         / widths[None, :, None]) ** 2)    # (B, P, size)
    gy = jnp.exp(-0.5 * ((grid[None, None] - pts[..., 1:])
                         / widths[None, :, None]) ** 2)
    frames = jnp.einsum("bpy,bpx,pc->byxc", gy, gx, cols)
    if noise:
        frames = frames + noise * jax.random.uniform(
            key, (b, size, size, 3))
    return jnp.clip(frames, 0.0, 1.0)
