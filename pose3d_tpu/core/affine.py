"""Affine crop/bbox geometry (HybrIK utility library, host + device halves).

Reference contract: phase3_direct/my_HybrIK/hybrik_utils.py —
``get_affine_transform`` (:1312-1346, center/scale/rot -> 2x3 crop matrix via
a 3-point correspondence), ``affine_transform`` (:1386-1389), the DPG bbox
jitter (:40-76 ``addDPG``), ``transform_preds``/``heatmap_to_coord``
(:1211-1265: heatmap uv in [-0.5,0.5] -> pixel coords through the inverse
bbox affine), ``rotate_xyz_jts`` (:1053-1063) and ``rot_aa`` (:1039-1050).

Design notes: the affine solve is closed-form numpy (no cv2 dependency
for the math; cv2 is only used to warp actual pixels host-side);
``affine_transform``/``transform_preds`` are vectorized over arbitrary
leading axes and jnp-compatible so the decode runs on device.
"""

from __future__ import annotations

import numpy as np


def _rotate_2d(point, rad):
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([point[0] * cs - point[1] * sn,
                     point[0] * sn + point[1] * cs], dtype=np.float64)


def _third_point(a, b):
    """Perpendicular completion of a 2-point frame (hybrik_utils get_3rd_point
    semantics: a + rot90(b - a))."""
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float64)


def _solve_affine(src, dst):
    """2x3 affine mapping three src points onto three dst points
    (cv2.getAffineTransform equivalent, closed-form solve)."""
    a = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3,3)
    t = np.linalg.solve(a, dst)  # (3,2)
    return t.T  # (2,3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """Crop transform: image coords -> output_size patch coords (2x3).

    center (2,): bbox centre; scale: scalar or (2,) source extent in pixels;
    rot: degrees; output_size (w, h). ``inv`` returns the patch->image
    transform. Matches hybrik_utils.py:1312-1346.
    """
    center = np.asarray(center, np.float64)
    scale = np.asarray(
        [scale, scale] if np.isscalar(scale) else scale, np.float64
    )
    shift = np.asarray(shift, np.float64)
    dst_w, dst_h = output_size

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_2d([0.0, scale[0] * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src).astype(np.float32)
    return _solve_affine(src, dst).astype(np.float32)


def affine_transform(points, t):
    """Apply a (.., 2x3) affine to (..., 2) points (vectorized; jnp ok)."""
    xy = points[..., :2]
    return xy @ t[..., :2].swapaxes(-1, -2) + t[..., 2]


def bbox_to_center_scale(bbox, aspect_ratio: float = 1.0,
                         scale_mult: float = 1.25):
    """xyxy bbox -> (center (2,), scale (2,)) with aspect correction — the
    standard HybrIK bbox preprocessing (hybrik_utils _box_to_center_scale
    semantics)."""
    xmin, ymin, xmax, ymax = [float(v) for v in bbox]
    w, h = xmax - xmin, ymax - ymin
    center = np.array([xmin + w * 0.5, ymin + h * 0.5])
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    else:
        w = h * aspect_ratio
    return center, np.array([w, h]) * scale_mult


def dpg_jitter(bbox, img_w: int, img_h: int, rng: np.random.Generator):
    """DPG bbox augmentation (hybrik_utils.py:40-76 ``addDPG``) with an
    explicit generator instead of global random state."""
    xmin, ymin, xmax, ymax = [float(v) for v in bbox]
    width, ht = xmax - xmin, ymax - ymin
    patch_scale = rng.uniform(0, 1)
    if patch_scale > 0.85:
        ratio = ht / width
        if width < ht:
            pw = patch_scale * width
            ph = pw * ratio
        else:
            ph = patch_scale * ht
            pw = ph / ratio
        new_xmin = xmin + rng.uniform(0, 1) * (width - pw)
        new_ymin = ymin + rng.uniform(0, 1) * (ht - ph)
        return np.array([new_xmin, new_ymin, new_xmin + pw + 1,
                         new_ymin + ph + 1])
    new_xmin = max(1, min(xmin + rng.normal(-0.0142, 0.1158) * width, img_w - 3))
    new_ymin = max(1, min(ymin + rng.normal(0.0043, 0.068) * ht, img_h - 3))
    new_xmax = min(max(new_xmin + 2, xmax + rng.normal(0.0154, 0.1337) * width),
                   img_w - 3)
    new_ymax = min(max(new_ymin + 2, ymax + rng.normal(-0.0013, 0.0711) * ht),
                   img_h - 3)
    return np.array([new_xmin, new_ymin, new_xmax, new_ymax])


def crop_image(img, center, scale, rot, output_size):
    """Warp the bbox patch out of an image (host-side cv2; the pixel half of
    hybrik_utils cv_cropBox/:142-249)."""
    import cv2

    t = get_affine_transform(center, scale, rot, output_size)
    return cv2.warpAffine(img, t, tuple(int(v) for v in output_size),
                          flags=cv2.INTER_LINEAR)


def box_crop_affine(bbox, output_size, inv: bool = False) -> np.ndarray:
    """2x3 affine of the bbox-variant crop family (hybrik_utils
    ``cv_cropBox``/``cv_cropBoxInverse``, :142-193/:347-402): the box is
    symmetrically padded to the output aspect ratio and its padded corners
    mapped onto the patch corners. Reproduces the reference's exact corner
    conventions (xmax/ymax decremented by 1, floor-div pad, resW-1/resH-1
    far corner). ``output_size`` is (height, width) as in the reference;
    ``inv`` returns the patch->image transform.
    """
    xmin, ymin, xmax, ymax = [float(v) for v in bbox]
    xmax -= 1.0
    ymax -= 1.0
    res_h, res_w = output_size
    len_h = max(ymax - ymin, (xmax - xmin) * res_h / res_w)
    len_w = len_h * res_w / res_h
    pad_h = (len_h - (ymax - ymin)) // 2
    pad_w = (len_w - (xmax - xmin)) // 2

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = [xmin - pad_w, ymin - pad_h]
    src[1] = [xmax + pad_w, ymax + pad_h]
    dst[0] = [0.0, 0.0]
    dst[1] = [res_w - 1.0, res_h - 1.0]
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])
    if inv:
        return _solve_affine(dst, src).astype(np.float32)
    return _solve_affine(src, dst).astype(np.float32)


def crop_box(img, bbox, output_size):
    """``cv_cropBox`` (hybrik_utils.py:142-193): zero everything outside the
    bbox, then warp the aspect-padded box onto an (output_h, output_w)
    patch. ``img`` is HWC (this framework's convention; the reference is
    CHW torch) and is not modified in place (the reference mutates it).
    """
    import cv2

    xmin, ymin, xmax, ymax = [int(v) for v in bbox]
    masked = np.zeros_like(img)
    masked[max(ymin, 0):ymax, max(xmin, 0):xmax] = \
        img[max(ymin, 0):ymax, max(xmin, 0):xmax]
    t = box_crop_affine(bbox, output_size)
    res_h, res_w = output_size
    return cv2.warpAffine(masked, t, (int(res_w), int(res_h)),
                          flags=cv2.INTER_LINEAR)


def crop_box_rot(img, bbox, output_size, rot):
    """``cv_cropBox_rot`` (hybrik_utils.py:196-249): centre-based crop of
    the bbox with an in-plane rotation (no outside-box zeroing — matching
    the reference, which skips it in the _rot variant). HWC in/out."""
    import cv2

    xmin, ymin, xmax, ymax = [float(v) for v in bbox]
    xmax -= 1.0
    ymax -= 1.0
    res_h, res_w = output_size
    rot_rad = np.pi * rot / 180.0
    center = np.array([(xmax + xmin) / 2, (ymax + ymin) / 2])
    src_dir = _rotate_2d([0.0, (ymax - ymin) * -0.5], rot_rad)
    dst_dir = np.array([0.0, (res_h - 1.0) * -0.5])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [(res_w - 1.0) * 0.5, (res_h - 1.0) * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])
    t = _solve_affine(src, dst).astype(np.float32)
    return cv2.warpAffine(img, t, (int(res_w), int(res_h)),
                          flags=cv2.INTER_LINEAR)


def fix_box(bbox, output_size):
    """The aspect-fix half of ``fix_cropBox`` (hybrik_utils.py:250-288):
    symmetrically expand one side of the box to the output aspect ratio and
    truncate to ints (the reference's ``int(x)``)."""
    xmin, ymin, xmax, ymax = [float(v) for v in bbox]
    input_ratio = output_size[0] / output_size[1]
    bbox_ratio = (ymax - ymin) / (xmax - xmin)
    if bbox_ratio > input_ratio:
        cx = (xmax + xmin) / 2
        w = (ymax - ymin) / input_ratio
        xmin, xmax = cx - w / 2, cx + w / 2
    elif bbox_ratio < input_ratio:
        cy = (ymax + ymin) / 2
        h = (xmax - xmin) * input_ratio
        ymin, ymax = cy - h / 2, cy + h / 2
    return [int(v) for v in (xmin, ymin, xmax, ymax)]


def fix_crop_box(img, bbox, output_size):
    """``fix_cropBox``: aspect-fix the box, then ``crop_box``. Returns
    (patch, fixed_bbox) like the reference."""
    fixed = fix_box(bbox, output_size)
    return crop_box(img, fixed, output_size), fixed


def fix_crop_box_rot(img, bbox, output_size, rot):
    """``fix_cropBox_rot``: aspect-fix the box, then ``crop_box_rot``."""
    fixed = fix_box(bbox, output_size)
    return crop_box_rot(img, fixed, output_size, rot), fixed


def crop_box_inverse(patch, bbox, img_size, output_size):
    """``cv_cropBoxInverse`` (hybrik_utils.py:347-402): paste an
    (output_h, output_w) patch back into a zeroed (img_h, img_w) canvas
    through the inverse box affine. HWC in/out."""
    import cv2

    t = box_crop_affine(bbox, output_size, inv=True)
    img_h, img_w = img_size
    return cv2.warpAffine(patch, t, (int(img_w), int(img_h)),
                          flags=cv2.INTER_LINEAR)


def transform_preds(coords, center, scale, output_size):
    """Patch-space (…,2) coords -> original image coords through the inverse
    crop affine (hybrik_utils.py:1256-1260), vectorized over all joints."""
    t = get_affine_transform(center, scale, 0, output_size, inv=True)
    return affine_transform(coords, t)


def heatmap_uvd_to_image_coords(pred_jts, bbox, hm_shape=(64, 64),
                                output_3d: bool = True,
                                mean_bbox_scale=None):
    """Soft-argmax uvd in [-0.5,0.5] -> image-space coords
    (hybrik_utils.py:1211-1253 ``heatmap_to_coord``), vectorized over
    (..., J, 3)."""
    hm_w, hm_h = hm_shape
    coords = np.array(pred_jts, dtype=np.float64)
    coords[..., 0] = (coords[..., 0] + 0.5) * hm_w
    coords[..., 1] = (coords[..., 1] + 0.5) * hm_h

    xmin, ymin, xmax, ymax = bbox
    w, h = xmax - xmin, ymax - ymin
    center = np.array([xmin + w * 0.5, ymin + h * 0.5])
    scale = np.array([w, h])
    out = np.array(coords)
    out[..., :2] = transform_preds(coords[..., :2], center, scale,
                                   [hm_w, hm_h])
    if output_3d and mean_bbox_scale is not None:
        out[..., 2] = coords[..., 2] / (scale[0] / mean_bbox_scale)
    return out


def rotate_points_2d(points, rot_deg):
    """Rotate (...,>=2) joints about the origin in the xy plane
    (hybrik_utils.py:1053-1063 ``rotate_xyz_jts``)."""
    rad = -np.pi * rot_deg / 180.0
    sn, cs = np.sin(rad), np.cos(rad)
    out = np.array(points, dtype=np.float64, copy=True)
    out[..., 0] = points[..., 0] * cs - points[..., 1] * sn
    out[..., 1] = points[..., 0] * sn + points[..., 1] * cs
    return out


def rot_aa(aa, rot_deg):
    """Rotate an axis-angle global orientation by an in-plane camera rotation
    (hybrik_utils.py:1039-1050): R_z(-rot) applied to rodrigues(aa)."""
    import jax.numpy as jnp

    from pose3d_tpu.models.smpl import batch_rodrigues

    rad = np.deg2rad(-rot_deg)
    rz = np.array([
        [np.cos(rad), -np.sin(rad), 0.0],
        [np.sin(rad), np.cos(rad), 0.0],
        [0.0, 0.0, 1.0],
    ])
    r = np.asarray(batch_rodrigues(jnp.asarray(aa, jnp.float32)[None]))[0]
    m = rz @ r
    # matrix -> axis-angle (inverse rodrigues)
    angle = np.arccos(np.clip((np.trace(m) - 1) / 2, -1, 1))
    if angle < 1e-7:
        return np.zeros(3)
    axis = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    axis = axis / (2 * np.sin(angle))
    return axis * angle
