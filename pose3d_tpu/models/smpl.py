"""SMPL body model: blend shapes, level-batched FK, linear blend skinning.

Reference contract: phase3_direct/my_HybrIK/SMPL.py:38-219 (buffer layout,
29-joint extended kinematic tree with 5 leaf vertices, root-centred outputs)
and lbs.py:195-288 (``lbs``: shape blendshapes -> joint regression ->
rodrigues -> rigid transform chain -> skinning -> H36M joint regression).

Redesign:
- the FK accumulation (lbs.py:516-530, a python loop of 23 sequential (B,4,4)
  matmuls) runs level-by-level over the kinematic tree: joints at the same
  depth batch into ONE (B,K,4,4) matmul, cutting the sequential chain from 23
  to 8 steps (the tree's depth);
- all blendshape/skinning contractions are einsums that map directly onto
  the matrix units; buffers are plain jnp arrays in a pytree (no nn.Module state).

Assets: the SMPL pickle (basicModel_neutral_lbs_10_207_0_v1.0.0.pkl) and
J_regressor_h36m.npy are licensed artifacts not shipped here
(simple3dposeBaseSMPL.py:79-97 loads them from disk); :func:`load_smpl` reads
them when present, and :func:`synthetic_model` builds a small consistent body
for tests/CI.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

NUM_JOINTS = 24
NUM_EXT_JOINTS = 29  # + 5 leaf vertices (SMPL.py:127-137)
NUM_BETAS = 10

# Standard SMPL kinematic tree (public model topology), extended with the
# HybrIK leaf joints head/L-middle/R-middle/L-bigtoe/R-bigtoe
# (SMPL.py:127-137): 24 -> jaw(15), 25 -> l_wrist... per the reference,
# parents[24]=15, [25]=22, [26]=23, [27]=10, [28]=11.
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21, 15, 22, 23, 10, 11],
    dtype=np.int32,
)

# Leaf vertex ids on the 6890-vertex SMPL mesh (lbs.py:352)
LEAF_VERTEX_IDS = (411, 2445, 5905, 3216, 6617)

# Depth levels of the extended tree (parents of level-l joints all sit in
# levels < l). Same schedule the reference's train-path uses (lbs.py:884-895).
IK_LEVELS = (
    (0,), (1, 2, 3), (4, 5, 6), (7, 8, 9), (12, 13, 14), (15, 16, 17),
    (18, 19, 10), (20, 21, 11), (22, 23), (24, 25, 26, 27, 28),
)
# FK levels over the 24 real joints, grouped by tree depth.
FK_LEVELS = (
    (1, 2, 3), (4, 5, 6), (7, 8, 9), (10, 11, 12, 13, 14), (15, 16, 17),
    (18, 19), (20, 21), (22, 23),
)


def children_map(parents: np.ndarray = PARENTS) -> np.ndarray:
    """First-child table with the reference's overrides
    (SMPL.py:149-162): leaves -1; children[0]=3 (spine1 drives the pelvis
    orient); children[9]=12 (neck; the -3 three-children-SVD marker is
    immediately overwritten in the reference, disabling that branch)."""
    children = -np.ones_like(parents)
    for i in range(len(parents)):
        p = parents[i]
        if p >= 0 and children[p] < 0:
            children[p] = i
    for leaf in range(24, len(parents)):
        children[leaf] = -1
    children[0] = 3
    children[9] = 12
    return children


CHILDREN = children_map()


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """Immutable buffer container (pytree of numpy arrays)."""

    v_template: np.ndarray      # (V, 3)
    shapedirs: np.ndarray       # (V, 3, 10)
    posedirs: np.ndarray        # (23*9, V*3)
    j_regressor: np.ndarray     # (24, V)
    j_regressor_h36m: np.ndarray  # (17, V)
    lbs_weights: np.ndarray     # (V, 24)
    parents: np.ndarray = dataclasses.field(default_factory=lambda: PARENTS)
    children: np.ndarray = dataclasses.field(default_factory=lambda: CHILDREN)
    leaf_vertex_ids: tuple = LEAF_VERTEX_IDS

    @property
    def num_vertices(self):
        return self.v_template.shape[0]


def load_smpl(pkl_path, h36m_regressor_path) -> SMPLModel:
    """Load the standard SMPL pickle + H36M regressor npy
    (simple3dposeBaseSMPL.py:79-97)."""
    import pickle

    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def to_np(x):
        if "scipy.sparse" in str(type(x)):
            x = x.todense()
        return np.asarray(x, dtype=np.float32)

    posedirs = to_np(data["posedirs"])  # (V, 3, 207)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, V*3)
    return SMPLModel(
        v_template=to_np(data["v_template"]),
        shapedirs=to_np(data["shapedirs"])[..., :NUM_BETAS],
        posedirs=posedirs,
        j_regressor=to_np(data["J_regressor"]),
        j_regressor_h36m=np.load(h36m_regressor_path).astype(np.float32),
        lbs_weights=to_np(data["weights"]),
    )


def synthetic_model(n_vertices: int = 800, seed: int = 0) -> SMPLModel:
    """Small self-consistent body for tests: joints regress from localized
    vertex clusters; skinning weights follow the same clusters."""
    rng = np.random.default_rng(seed)
    # place 24 plausible joint centres (rough human proportions, metres)
    joints = np.zeros((NUM_JOINTS, 3), np.float32)
    for i in range(1, NUM_JOINTS):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        joints[i] = joints[PARENTS[i]] + direction * rng.uniform(0.08, 0.3)
    # vertices scattered around joints
    owner = rng.integers(0, NUM_JOINTS, n_vertices)
    v_template = joints[owner] + rng.normal(scale=0.04, size=(n_vertices, 3))
    v_template = v_template.astype(np.float32)
    # regressor: average of each joint's own cluster
    j_reg = np.zeros((NUM_JOINTS, n_vertices), np.float32)
    for j in range(NUM_JOINTS):
        mask = owner == j
        if not mask.any():  # guarantee at least one vertex per joint
            k = rng.integers(0, n_vertices)
            owner[k] = j
            v_template[k] = joints[j]
            mask = owner == j
        j_reg[j, mask] = 1.0 / mask.sum()
    # correct the template so the regressor reproduces the joints exactly
    v_template += (joints - j_reg @ v_template)[owner]
    # h36m regressor: 17 random convex combos
    h36m = rng.random((17, n_vertices)).astype(np.float32)
    h36m /= h36m.sum(1, keepdims=True)
    w = np.zeros((n_vertices, NUM_JOINTS), np.float32)
    w[np.arange(n_vertices), owner] = 1.0
    leaf_ids = tuple(int(i) for i in rng.integers(0, n_vertices, 5))
    return SMPLModel(
        v_template=v_template,
        shapedirs=rng.normal(scale=0.01, size=(n_vertices, 3, NUM_BETAS)).astype(np.float32),
        posedirs=rng.normal(scale=0.001, size=(23 * 9, n_vertices * 3)).astype(np.float32),
        j_regressor=j_reg,
        j_regressor_h36m=h36m,
        lbs_weights=w,
        leaf_vertex_ids=leaf_ids,
    )


# --- math kernels -----------------------------------------------------------

def joints2bones(joints, parents=PARENTS[:24]):
    """Decompose (B,J,3) joints into unit bone directions + lengths
    (lbs.py:143-170): the root entry carries its absolute position and zero
    length. Vectorized (the reference loops per joint)."""
    parents = np.asarray(parents)
    safe = parents.clip(0)
    diff = joints - joints[:, safe]
    length = jnp.linalg.norm(diff, axis=-1, keepdims=True) + 1e-8
    is_root = (parents < 0)[None, :, None]
    dirs = jnp.where(is_root, joints, diff / length)
    lens = jnp.where(is_root, 0.0, length)
    return dirs, lens


def bones2joints(bone_dirs, bone_lens, parents=PARENTS[:24],
                 levels=FK_LEVELS):
    """Recompose joints from bone directions/lengths (lbs.py:173-192),
    accumulated level-by-level over the tree."""
    parents = np.asarray(parents)
    b = bone_lens.shape[0]
    joints = jnp.zeros((b,) + bone_dirs.shape[-2:], bone_dirs.dtype)
    joints = joints.at[:, 0].set(jnp.broadcast_to(bone_dirs[:, 0],
                                                  (b, 3)))
    for idx in levels:
        idx = list(idx)
        p = parents[idx]
        joints = joints.at[:, idx].set(
            joints[:, p] + bone_dirs[:, idx] * bone_lens[:, idx]
        )
    return joints


def batch_rodrigues(rot_vecs):
    """(...,3) axis-angle -> (...,3,3) rotation (lbs.py:446-477 semantics,
    incl. the +1e-8 angle regularization)."""
    angle = jnp.linalg.norm(rot_vecs + 1e-8, axis=-1, keepdims=True)
    axis = rot_vecs / angle
    cos = jnp.cos(angle)[..., None]
    sin = jnp.sin(angle)[..., None]
    K = _skew(axis)
    eye = jnp.eye(3, dtype=rot_vecs.dtype)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def _skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    ).reshape(v.shape[:-1] + (3, 3))


def quat_to_rotmat(quat):
    """(...,4) wxyz quaternion -> (...,3,3), normalized first
    (lbs.py:1204-1236 semantics)."""
    q = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True).clip(1e-8)
    from pose3d_tpu.core.quaternion import quat_to_rotmat as _q2r

    return _q2r(q)


def rotmat_to_quat(rot):
    """(...,3,3) -> (...,4) wxyz unit quaternion (robust, branch-free via
    jnp.where — equivalent to lbs.py:1122-1201's four-case construction)."""
    m = rot
    t = jnp.trace(m, axis1=-2, axis2=-1)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    qw = safe_sqrt(1 + t) / 2
    qx = safe_sqrt(1 + m00 - m11 - m22) / 2
    qy = safe_sqrt(1 - m00 + m11 - m22) / 2
    qz = safe_sqrt(1 - m00 - m11 + m22) / 2
    # pick the largest component for stability, fix signs from off-diagonals
    cands = jnp.stack([
        jnp.stack([qw,
                   (m[..., 2, 1] - m[..., 1, 2]) / (4 * qw),
                   (m[..., 0, 2] - m[..., 2, 0]) / (4 * qw),
                   (m[..., 1, 0] - m[..., 0, 1]) / (4 * qw)], -1),
        jnp.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * qx), qx,
                   (m[..., 0, 1] + m[..., 1, 0]) / (4 * qx),
                   (m[..., 0, 2] + m[..., 2, 0]) / (4 * qx)], -1),
        jnp.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * qy),
                   (m[..., 0, 1] + m[..., 1, 0]) / (4 * qy), qy,
                   (m[..., 1, 2] + m[..., 2, 1]) / (4 * qy)], -1),
        jnp.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * qz),
                   (m[..., 0, 2] + m[..., 2, 0]) / (4 * qz),
                   (m[..., 1, 2] + m[..., 2, 1]) / (4 * qz), qz], -1),
    ], axis=-2)  # (...,4 cases,4)
    comp = jnp.stack([qw, qx, qy, qz], -1)
    best = jnp.argmax(comp, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), -2)[..., 0, :]
    return q * jnp.sign(q[..., :1] + 1e-12)


def blend_shapes(betas, shapedirs):
    """(B,10) x (V,3,10) -> (B,V,3) (lbs.py:422-443)."""
    return jnp.einsum("bl,vkl->bvk", betas, shapedirs)


def vertices2joints(regressor, vertices):
    """(J,V) x (B,V,3) -> (B,J,3) (lbs.py:402-419)."""
    return jnp.einsum("jv,bvk->bjk", regressor, vertices)


def batch_rigid_transform(rot_mats, joints, parents=PARENTS[:24],
                          levels=FK_LEVELS):
    """FK: local rotations + rest joints -> posed joints + relative 4x4s.

    Level-batched redesign of lbs.py:493-548: one (B,K,3,3) matmul per tree
    depth. Returns (posed_joints (B,J,3), rel_transforms (B,J,4,4)).
    """
    b, j = joints.shape[:2]
    parents = np.asarray(parents)
    rel = joints - jnp.where(
        (parents >= 0)[None, :, None], joints[:, parents.clip(0)], 0.0
    )
    # chain rotations and global joint positions, accumulated by level
    chain = jnp.zeros((b, j, 3, 3), joints.dtype).at[:, 0].set(rot_mats[:, 0])
    pos = jnp.zeros((b, j, 3), joints.dtype).at[:, 0].set(joints[:, 0])
    for idx in levels:
        idx = list(idx)
        p = parents[idx]
        new_chain = chain[:, p] @ rot_mats[:, idx]
        new_pos = pos[:, p] + (chain[:, p] @ rel[:, idx, :, None])[..., 0]
        chain = chain.at[:, idx].set(new_chain)
        pos = pos.at[:, idx].set(new_pos)
    # relative transforms: [R | t - R @ j_rest] (lbs.py:540-546)
    t = pos - (chain @ joints[..., None])[..., 0]
    rel_tf = jnp.zeros((b, j, 4, 4), joints.dtype)
    rel_tf = rel_tf.at[..., :3, :3].set(chain)
    rel_tf = rel_tf.at[..., :3, 3].set(t)
    rel_tf = rel_tf.at[..., 3, 3].set(1.0)
    return pos, rel_tf


def skin(v_posed, rel_transforms, lbs_weights):
    """LBS: (B,V,3) + (B,J,4,4) + (V,J) -> (B,V,3) (lbs.py:272-285)."""
    t = jnp.einsum("vj,bjrc->bvrc", lbs_weights, rel_transforms)
    v = t[..., :3, :3] @ v_posed[..., None] + t[..., :3, 3:]
    return v[..., 0]


def lbs(model: SMPLModel, betas, pose, pose2rot: bool = True):
    """Full forward (lbs.py:195-288): returns (vertices, joints_24,
    rot_mats, joints_h36m), all root-raw (the SMPL_layer wrapper root-centres,
    SMPL.py:211-215)."""
    betas = jnp.asarray(betas)
    b = betas.shape[0]
    v_shaped = jnp.asarray(model.v_template) + blend_shapes(
        betas, jnp.asarray(model.shapedirs)
    )
    j_rest = vertices2joints(jnp.asarray(model.j_regressor), v_shaped)
    if pose2rot:
        rot_mats = batch_rodrigues(jnp.reshape(pose, (b, NUM_JOINTS, 3)))
    else:
        rot_mats = jnp.reshape(pose, (b, NUM_JOINTS, 3, 3))
    eye = jnp.eye(3, dtype=rot_mats.dtype)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(b, -1)
    pose_offsets = (pose_feature @ jnp.asarray(model.posedirs)).reshape(
        b, -1, 3
    )
    v_posed = v_shaped + pose_offsets
    joints, rel_tf = batch_rigid_transform(rot_mats, j_rest)
    verts = skin(v_posed, rel_tf, jnp.asarray(model.lbs_weights))
    joints_h36m = vertices2joints(jnp.asarray(model.j_regressor_h36m), verts)
    return verts, joints, rot_mats, joints_h36m
