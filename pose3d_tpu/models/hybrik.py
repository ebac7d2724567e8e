"""HybrIK inverse kinematics: joint positions + twist angles -> rotations.

Reference contract: lbs.py:291-399 (``hybrik`` entry), :551-756 (accurate
eval path with global-position correction and the >15 mm outlier clamp),
:759-934 (naive train path), :937-1049 (pelvis orientation, naive/SVD),
:1052-1088 (three-children SVD — present in the reference but disabled by the
children-map override at SMPL.py:158-160; see smpl.children_map).

Redesign:
- the per-joint python recursion over the 24/29-joint tree (a serial chain of
  per-joint (B,3,3) ops with data-dependent boolean indexing) becomes a loop
  over the tree's 10 static depth levels; every joint in a level is processed
  in one batched (B,K,...) computation — the same schedule the reference's
  train path uses (lbs.py:884-895), here applied to BOTH paths;
- the eval-time data-dependent clamp (lbs.py:689-698, boolean indexing) is a
  jnp.where; the SVD orientations use jnp.linalg.svd with the determinant
  sign fix (no host round-trip — the reference moves tensors to CPU for
  torch.svd, lbs.py:958-960).

Swing-twist decomposition per joint (lbs.py:705-751):
  swing: Rodrigues rotation aligning the rest bone to the observed bone;
  twist: rotation of angle phi about the rest bone axis;  local = swing @ twist.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pose3d_tpu.models.smpl import (
    CHILDREN,
    IK_LEVELS,
    PARENTS,
    SMPLModel,
    _skew,
    batch_rigid_transform,
    blend_shapes,
    skin,
    vertices2joints,
)


def _rodrigues_from_axis(axis_unit, cos, sin):
    """R = I + sin K + (1-cos) K^2 with K = skew(axis). axis (...,3),
    cos/sin (...,1)."""
    K = _skew(axis_unit)
    eye = jnp.eye(3, dtype=axis_unit.dtype)
    return eye + sin[..., None] * K + (1.0 - cos[..., None]) * (K @ K)


def rotmat_between(vec_rest, vec_final):
    """Rotation aligning vec_rest to vec_final, the reference's exact
    formulation incl. epsilons (vectors2rotmat, lbs.py:1090-1119). Inputs
    (...,3)."""
    rest_norm = jnp.linalg.norm(vec_rest, axis=-1, keepdims=True)
    final_norm = jnp.linalg.norm(vec_final, axis=-1, keepdims=True)
    axis = jnp.cross(vec_rest, vec_final)
    axis_norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    cos = jnp.sum(vec_rest * vec_final, axis=-1, keepdims=True) / (
        rest_norm * final_norm + 1e-8
    )
    sin = axis_norm / (rest_norm * final_norm + 1e-8)
    axis = axis / (axis_norm + 1e-8)
    return _rodrigues_from_axis(axis, cos, sin)


def _kabsch(rest_mat, target_mat):
    """Orthogonal Procrustes with det correction (lbs.py:958-971):
    S = rest @ targetᵀ; R = V diag(1,1,det(VUᵀ)) Uᵀ. Inputs (...,3,K)."""
    s = rest_mat @ jnp.swapaxes(target_mat, -1, -2)
    u, _, vt = jnp.linalg.svd(s)
    v = jnp.swapaxes(vt, -1, -2)
    det = jnp.linalg.det(v @ jnp.swapaxes(u, -1, -2))
    fix = jnp.broadcast_to(jnp.eye(3, dtype=s.dtype), s.shape).copy()
    fix = fix.at[..., 2, 2].set(det)
    rot = v @ fix @ jnp.swapaxes(u, -1, -2)
    # all-zero S (degenerate) -> identity (lbs.py:954-956)
    zero = jnp.sum(jnp.abs(s), axis=(-1, -2), keepdims=True) == 0
    return jnp.where(zero, jnp.eye(3, dtype=s.dtype), rot)


def _pelvis_children(parents=PARENTS, children=CHILDREN):
    out = [int(children[0])]
    for i in range(1, len(parents)):
        if parents[i] == 0 and i not in out:
            out.append(i)
    return out  # [3, 1, 2]


def pelvis_orient_svd(rel_pose, rel_rest):
    """Eval-path pelvis orientation: Kabsch over the pelvis' three child
    bones (lbs.py:937-976). rel_* : (B,29,3)."""
    idx = _pelvis_children()
    rest_mat = jnp.stack([rel_rest[:, c] for c in idx], axis=-1)    # (B,3,K)
    target_mat = jnp.stack([rel_pose[:, c] for c in idx], axis=-1)
    return _kabsch(rest_mat, target_mat)


def pelvis_orient_naive(rel_pose, rel_rest):
    """Train-path pelvis orientation (lbs.py:979-1049): align the spine bone,
    then rotate about the spine axis to align the hip-midpoint direction
    (projected perpendicular to the spine)."""
    spine = int(CHILDREN[0])
    others = [c for c in _pelvis_children() if c != spine]
    spine_final = rel_pose[:, spine]
    spine_rest = rel_rest[:, spine]
    spine_axis = spine_final / (
        jnp.linalg.norm(spine_final, axis=-1, keepdims=True) + 1e-8
    )
    rot_spine = rotmat_between(spine_rest, spine_final)

    center_final = sum(rel_pose[:, c] for c in others) / len(others)
    center_rest = sum(rel_rest[:, c] for c in others) / len(others)
    center_rest = (rot_spine @ center_rest[..., None])[..., 0]

    def project_out(v):
        return v - jnp.sum(v * spine_axis, -1, keepdims=True) * spine_axis

    center_final, center_rest = project_out(center_final), project_out(center_rest)
    rot_center = rotmat_between(center_rest, center_final)
    return rot_center @ rot_spine


def three_children_orient_svd(children_final, children_rest, chain_parent):
    """SVD orientation over several child bones (lbs.py:1052-1088). Present
    for completeness; the reference's children-map override disables the
    branch that calls it."""
    target = jnp.stack(
        [
            (jnp.swapaxes(chain_parent, -1, -2) @ c[..., None])[..., 0]
            for c in children_final
        ],
        axis=-1,
    )
    rest = jnp.stack(children_rest, axis=-1)
    return _kabsch(rest, target)


def inverse_kinematics(
    pose_skeleton, phis, rest_pose, *, train: bool = False,
    global_orient=None, leaf_thetas=None,
    parents=PARENTS, children=CHILDREN, levels=IK_LEVELS,
):
    """Joint positions -> per-joint local rotations.

    pose_skeleton: (B,29,3) predicted joints (camera frame, root-relative ok);
    phis: (B,23,2) twist (cos,sin) per non-root body joint;
    rest_pose: (B,29,3) rest joints (24 regressed + 5 leaf vertices);
    leaf_thetas: optional (B,5,3,3) leaf rotations.
    Returns (rot_mats (B,24,3,3), rotate_rest_pose (B,29,3)).
    """
    b = pose_skeleton.shape[0]
    dtype = pose_skeleton.dtype
    parents = np.asarray(parents)
    children = np.asarray(children)

    par_safe = parents.clip(0)
    rel_rest = rest_pose - jnp.where(
        (parents >= 0)[None, :, None], rest_pose[:, par_safe], 0.0
    )
    rel_pose = pose_skeleton - jnp.where(
        (parents >= 0)[None, :, None], pose_skeleton[:, par_safe], 0.0
    )
    rel_pose = rel_pose.at[:, 0].set(rel_rest[:, 0])
    rel_pose = jax.lax.stop_gradient(rel_pose)  # .detach() (lbs.py:597)
    final_pose = pose_skeleton - pose_skeleton[:, :1] + rel_rest[:, :1]

    phis = phis / (jnp.linalg.norm(phis, axis=-1, keepdims=True) + 1e-8)

    if global_orient is not None:
        root_rot = global_orient
    elif train:
        root_rot = pelvis_orient_naive(rel_pose, rel_rest)
    else:
        root_rot = pelvis_orient_svd(rel_pose, rel_rest)

    chain = jnp.zeros((b, len(parents), 3, 3), dtype).at[:, 0].set(root_rot)
    local = jnp.zeros((b, 24, 3, 3), dtype).at[:, 0].set(root_rot)
    rot_rest = jnp.zeros((b, len(parents), 3), dtype).at[:, 0].set(rel_rest[:, 0])

    for level in levels[1:]:
        leaves = [i for i in level if children[i] == -1]
        body = [i for i in level if children[i] != -1]
        if body:
            idx = np.asarray(body)
            p = parents[idx]
            c = children[idx]
            # global position of this joint after the chain so far
            new_pos = rot_rest[:, p] + (
                chain[:, p] @ rel_rest[:, idx, :, None]
            )[..., 0]
            rot_rest = rot_rest.at[:, idx].set(new_pos)

            if train:
                # naive: local observed bone (lbs.py:917-920)
                child_final = rel_pose[:, c]
            else:
                # accurate: aim at the final global child position
                child_final = final_pose[:, c] - new_pos
                # outlier clamp (lbs.py:689-698): if the corrected target
                # drifts >15mm from the (rescaled) observed bone, fall back
                orig = rel_pose[:, c]
                t_norm = jnp.linalg.norm(rel_rest[:, c], axis=-1, keepdims=True)
                orig = orig * t_norm / jnp.linalg.norm(orig, axis=-1, keepdims=True)
                diff = jnp.linalg.norm(child_final - orig, axis=-1, keepdims=True)
                child_final = jnp.where(diff > 15.0 / 1000.0, orig, child_final)
            # rotate into the parent's frame
            child_final = (
                jnp.swapaxes(chain[:, p], -1, -2) @ child_final[..., None]
            )[..., 0]
            child_rest = rel_rest[:, c]

            swing = rotmat_between(child_rest, child_final)
            rest_norm = jnp.linalg.norm(child_rest, axis=-1, keepdims=True)
            twist_axis = child_rest / (rest_norm + 1e-8)
            cos = phis[:, idx - 1, 0:1]
            sin = phis[:, idx - 1, 1:2]
            twist = _rodrigues_from_axis(twist_axis, cos, sin)
            rot = swing @ twist
            chain = chain.at[:, idx].set(chain[:, p] @ rot)
            local = local.at[:, idx].set(rot)
        if leaves:
            idx = np.asarray(leaves)
            p = parents[idx]
            new_pos = rot_rest[:, p] + (
                chain[:, p] @ rel_rest[:, idx, :, None]
            )[..., 0]
            rot_rest = rot_rest.at[:, idx].set(new_pos)
            if leaf_thetas is not None:
                order = {j: k for k, j in enumerate(sorted(leaves))}
                rot = jnp.stack([leaf_thetas[:, order[j]] for j in idx], 1)
                chain = chain.at[:, idx].set(chain[:, p] @ rot)
    return local, rot_rest


def hybrik(model: SMPLModel, betas, pose_skeleton, phis, *,
           global_orient=None, leaf_thetas=None, train: bool = False,
           naive: bool | None = None):
    """Full HybrIK pass (lbs.py:291-399): betas + predicted skeleton + twists
    -> (vertices, joints_24, rot_mats, joints_h36m), root-raw.

    ``naive`` overrides the train/eval IK-path selection (reference dispatch
    lbs.py:356-365: train -> naive, eval -> accurate/SVD).
    """
    betas = jnp.asarray(betas)
    b = betas.shape[0]
    naive = train if naive is None else naive

    v_shaped = jnp.asarray(model.v_template) + blend_shapes(
        betas, jnp.asarray(model.shapedirs)
    )
    rest_24 = vertices2joints(jnp.asarray(model.j_regressor), v_shaped)
    leaf = v_shaped[:, list(model.leaf_vertex_ids)]
    rest_j = jnp.concatenate([rest_24, leaf], axis=1)  # (B,29,3)

    rot_mats, _ = inverse_kinematics(
        pose_skeleton, phis, rest_j, train=naive,
        global_orient=global_orient, leaf_thetas=leaf_thetas,
        parents=model.parents, children=model.children,
    )
    joints, rel_tf = batch_rigid_transform(rot_mats, rest_24)

    eye = jnp.eye(3, dtype=rot_mats.dtype)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(b, -1)
    pose_offsets = (pose_feature @ jnp.asarray(model.posedirs)).reshape(b, -1, 3)
    v_posed = v_shaped + pose_offsets
    verts = skin(v_posed, rel_tf, jnp.asarray(model.lbs_weights))
    joints_h36m = vertices2joints(jnp.asarray(model.j_regressor_h36m), verts)
    return verts, joints, rot_mats, joints_h36m


def root_centre_outputs(verts, joints, joints_h36m, root_idx_17: int = 0):
    """The SMPL_layer wrapper's root-centring (SMPL.py:211-215 / :266-273),
    with stop_gradient standing in for .detach()."""
    sg = jax.lax.stop_gradient
    verts = verts - sg(joints_h36m[:, root_idx_17:root_idx_17 + 1])
    joints = joints - sg(joints[:, :1])
    joints_h36m = joints_h36m - sg(joints_h36m[:, root_idx_17:root_idx_17 + 1])
    return verts, joints, joints_h36m
