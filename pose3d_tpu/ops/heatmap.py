"""Volumetric heatmap ops: Gaussian target synthesis and soft-argmax decode.

Reference contracts:
- 3D Gaussian synthesis (phase3_direct/my_HybrIK/H36_dataset.py:148-202):
  keypoint in [-1,1]^3 -> axis remap xyz->uvw = (-y,-z,x) (:143-144) ->
  scale 31.5*(1+k) into a 64^3 grid -> a sigma=0.5 Gaussian evaluated on a
  3^3 window centred at rint(k) (window size ceil(6*sigma) forced odd),
  zero outside the window.
- 3D soft-argmax (phase3_direct/my_HybrIK/Model.py:118-182): global softmax
  over the 64^3 volume per joint, marginalize to per-axis distributions,
  expectation against arange, rescale x,y -> (E/64 - .5)*2 and
  z -> (E/64 - .5)*z_scale with z_scale=2.5 (phase3) or 2.0
  (phase4_joined/Model.py:126-128).
- 2D soft-argmax (phase5_loop/Model_2d.py:96-134): softmax over 64^2,
  expectations normalized to [0,1] (no centring, no scale).

Design:
- synthesis is separable: three windowed 1-D Gaussians combined by outer
  product (einsum) — vmappable over (B, J), no scatter, no dynamic shapes;
- decode computes the three marginal expectations directly from the softmax
  probabilities in one fused XLA computation; the (B,J,64^3) tensor is
  produced once and consumed by three reductions XLA fuses into a single
  pass.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

GRID = 64
SIGMA = 0.5


def xyz_to_uvw(kp):
    """Axis remap for heatmap storage (H36_dataset.py:143-144):
    (x,y,z) -> (-y,-z,x). kp: (...,3)."""
    return jnp.stack([-kp[..., 1], -kp[..., 2], kp[..., 0]], axis=-1)


def uvw_to_xyz(kp):
    """Inverse remap (Model.py:129-130): (u,v,w) -> (w,-u,-v)."""
    return jnp.stack([kp[..., 2], -kp[..., 0], -kp[..., 1]], axis=-1)


def _axis_profile(k, grid: int, sigma: float):
    """Windowed 1-D Gaussian: exp(-(i-k)^2 / 2 sigma^2) on the reference's
    integer window |i - rint(k)| <= size//2, zero elsewhere. k: (...,)."""
    size = int(math.ceil(6 * sigma))
    if size % 2 == 0:
        size += 1
    half = size // 2
    idx = jnp.arange(grid, dtype=jnp.float32)
    k = k[..., None]  # (...,1) against (grid,)
    g = jnp.exp(-jnp.square(idx - k) / (2.0 * sigma * sigma))
    window = jnp.abs(idx - jnp.rint(k)) <= half
    return jnp.where(window, g, 0.0)


def gaussian_heatmap_3d(kp_uvw, grid=GRID, sigma: float = SIGMA):
    """(..., 3) uvw keypoints in [-1,1] -> (..., gu, gv, gw) heatmaps.

    Matches ``_keypoint_to_heatmap_3D`` (H36_dataset.py:148-194): scale
    31.5*(1+k) (generalized to (g/2 - .5)*(1+k) for non-64 grids), separable
    Gaussian on the odd window around rint(k); the reference's boundary
    cropping is equivalent to our index-space masking. ``grid`` may be an int
    (cubic) or a (gu, gv, gw) tuple.
    """
    gu_n, gv_n, gw_n = (grid,) * 3 if isinstance(grid, int) else grid
    profiles = []
    for axis, g in enumerate((gu_n, gv_n, gw_n)):
        k = (g / 2.0 - 0.5) * (1.0 + kp_uvw[..., axis])
        profiles.append(_axis_profile(k, g, sigma))
    gu, gv, gw = profiles
    return jnp.einsum("...u,...v,...w->...uvw", gu, gv, gw)


def heatmap_targets(kp3d, grid=GRID, sigma: float = SIGMA):
    """(B,J,3) xyz keypoints in [-1,1] -> (B,J,gu,gv,gw) targets,
    with the reference's xyz->uvw storage remap applied."""
    return gaussian_heatmap_3d(xyz_to_uvw(kp3d), grid, sigma)


def soft_argmax_3d(logits, num_joints: int = 17, depth: int = GRID,
                   height: int = GRID, width: int = GRID,
                   z_scale: float = 2.5, xy_scale: float = 2.0,
                   return_heatmap: bool = True):
    """Volumetric soft-argmax decode (Model.py:118-182).

    logits: (B, J*depth, height, width) conv output or (B, J, depth, height,
    width). Returns (coords (B, J*3), heatmap (B,J,D,H,W) or None).
    coords: (E/dim - 0.5) * scale with the reference's scales — Model_3D uses
    xy_scale=2, z_scale=2.5 (phase4: 2.0); Simple3DPoseBaseSMPL keeps raw
    [-0.5, 0.5] coords, i.e. xy_scale=z_scale=1 (simple3dpose...py:257-259).
    """
    b = logits.shape[0]
    hm = logits.reshape(b, num_joints, depth * height * width)
    # softmax in f32 for stability regardless of compute dtype
    acc = jnp.promote_types(hm.dtype, jnp.float32)
    p = jnp.asarray(
        jnp.exp(
            hm.astype(acc)
            - jnp.max(hm, axis=-1, keepdims=True).astype(acc)
        )
    )
    p = p / jnp.sum(p, axis=-1, keepdims=True)
    p5 = p.reshape(b, num_joints, depth, height, width)

    hm_x = p5.sum(axis=(2, 3))  # (B,J,W)
    hm_y = p5.sum(axis=(2, 4))  # (B,J,H)
    hm_z = p5.sum(axis=(3, 4))  # (B,J,D)
    ex = hm_x @ jnp.arange(width, dtype=jnp.float32)
    ey = hm_y @ jnp.arange(height, dtype=jnp.float32)
    ez = hm_z @ jnp.arange(depth, dtype=jnp.float32)

    cx = (ex / width - 0.5) * xy_scale
    cy = (ey / height - 0.5) * xy_scale
    cz = (ez / depth - 0.5) * z_scale
    coords = jnp.stack([cx, cy, cz], axis=-1).reshape(b, num_joints * 3)
    return coords, (p5 if return_heatmap else None)


def gaussian_heatmap_2d(pt, shape=(64, 64), sigma: float = 2.0):
    """2D Gaussian target with centre value 1 (hybrik_utils.py:464-509
    ``drawGaussian``): window 3*sigma around int(pt), zero outside; pt (...,2)
    in (x, y) pixel coords of the target map."""
    h, w = shape
    tmp = int(3 * sigma)
    px = jnp.floor(pt[..., 0])  # int(pt) truncation for the window centre
    py = jnp.floor(pt[..., 1])
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    # unnormalized gaussian evaluated at integer-centre offsets (the
    # reference centres g on the window midpoint = int(pt) + 0)
    gx = jnp.exp(-jnp.square(xs - px[..., None]) / (2 * sigma * sigma))
    gy = jnp.exp(-jnp.square(ys - py[..., None]) / (2 * sigma * sigma))
    gx = jnp.where(jnp.abs(xs - px[..., None]) <= tmp, gx, 0.0)
    gy = jnp.where(jnp.abs(ys - py[..., None]) <= tmp, gy, 0.0)
    return jnp.einsum("...y,...x->...yx", gy, gx)


def norm_heatmap(norm_type: str, heatmap):
    """Heatmap normalization family (hybrik_utils.py:1159-1178): softmax /
    sigmoid / divide_sum over the flattened per-joint map. heatmap (N,C,...)."""
    shape = heatmap.shape
    if norm_type == "softmax":
        flat = heatmap.reshape(shape[0], shape[1], -1)
        return jax.nn.softmax(flat, axis=2).reshape(shape)
    if norm_type == "sigmoid":
        return jax.nn.sigmoid(heatmap)
    if norm_type == "divide_sum":
        flat = heatmap.reshape(shape[0], shape[1], -1)
        flat = flat / jnp.sum(flat, axis=2, keepdims=True)
        return flat.reshape(shape)
    raise NotImplementedError(norm_type)


def hard_argmax_2d(heatmaps):
    """(B,J,H,W) -> ((B,J,2) integer (x,y) peaks, (B,J) max values) — the
    classic decode (hybrik_utils.py:1267-1311 ``get_max_pred_batch`` family)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, -1)
    idx = jnp.argmax(flat, axis=-1)
    maxvals = jnp.max(flat, axis=-1)
    x = (idx % w).astype(jnp.float32)
    y = (idx // w).astype(jnp.float32)
    coords = jnp.stack([x, y], axis=-1)
    # zero out coords where the peak is non-positive (reference convention)
    return jnp.where(maxvals[..., None] > 0, coords, 0.0), maxvals


def soft_argmax_3d_nhwc(logits_nhwc, num_joints: int = 17, depth: int = GRID,
                        z_scale: float = 2.5, xy_scale: float = 2.0):
    """Volumetric soft-argmax directly on the conv head's NHWC output
    (B, H, W, J*depth) — same math as :func:`soft_argmax_3d` but without the
    1-GB-scale NCHW transpose (and its gradient) the layout change costs.
    The channel dim splits into (J, depth) for free.

    Returns coords (B, J*3) with the reference scaling.
    """
    b, h, w, _ = logits_nhwc.shape
    x = logits_nhwc.reshape(b, h, w, num_joints, depth)
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    m = jnp.max(x, axis=(1, 2, 4), keepdims=True)
    p = jnp.exp(x - m)
    s = jnp.sum(p, axis=(1, 2, 4), keepdims=True)
    p = p / s
    ex = jnp.einsum("bhwjd,w->bj", p, jnp.arange(w, dtype=jnp.float32))
    ey = jnp.einsum("bhwjd,h->bj", p, jnp.arange(h, dtype=jnp.float32))
    ez = jnp.einsum("bhwjd,d->bj", p, jnp.arange(depth, dtype=jnp.float32))
    cx = (ex / w - 0.5) * xy_scale
    cy = (ey / h - 0.5) * xy_scale
    cz = (ez / depth - 0.5) * z_scale
    return jnp.stack([cx, cy, cz], axis=-1).reshape(b, num_joints * 3)


def soft_argmax_2d(logits, num_joints: int = 17, height: int = GRID,
                   width: int = GRID):
    """2D soft-argmax (Model_2d.py:96-134): coords in [0,1], (B, J*2)."""
    b = logits.shape[0]
    hm = logits.reshape(b, num_joints, height * width)
    p = jnp.exp(
        hm.astype(jnp.promote_types(hm.dtype, jnp.float32))
        - jnp.max(hm, axis=-1, keepdims=True).astype(
            jnp.promote_types(hm.dtype, jnp.float32))
    )
    p = p / jnp.sum(p, axis=-1, keepdims=True)
    p = p.reshape(b, num_joints, height, width)
    ex = p.sum(axis=2) @ jnp.arange(width, dtype=jnp.float32)
    ey = p.sum(axis=3) @ jnp.arange(height, dtype=jnp.float32)
    coords = jnp.stack([ex / width, ey / height], axis=-1)
    return coords.reshape(b, num_joints * 2)
