"""Quaternion math as vectorized JAX ops.

Reference semantics: phase3_direct/my_HybrIK/utils.py:324-340 (``q_conjugate``,
``q_mult``, ``qv_mult``) — scalar-first (w,x,y,z) Hamilton quaternions, vector
rotation via q * (0,v) * q^-1.

Design: everything is batched over leading axes and closed over
jnp primitives, so a whole (N,17,3) point cloud rotates in one fused kernel
(vs. the reference's per-joint python loop at H36_dataset.py:358-360).
"""

from __future__ import annotations

import jax.numpy as jnp


def q_conjugate(q):
    """Conjugate of (...,4) scalar-first quaternions (utils.py:324-326)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def q_mult(q1, q2):
    """Hamilton product of (...,4) quaternions (utils.py:328-335)."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    )


def qv_mult(q, v):
    """Rotate (...,3) vectors by (...,4) quaternions (utils.py:337-340).

    Broadcasts: q (...,4) against v (...,3) over leading axes.
    """
    zeros = jnp.zeros(v.shape[:-1] + (1,), dtype=v.dtype)
    qv = jnp.concatenate([zeros, v], axis=-1)
    return q_mult(q_mult(q, qv), q_conjugate(q))[..., 1:]


def quat_to_rotmat(q):
    """(...,4) scalar-first quaternion -> (...,3,3) rotation matrix.

    Same closed form the reference inlines at phase2_opp_mb/run.py:312-316.
    Assumes unit quaternions (true for the H36M camera orientations).
    """
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    r = jnp.stack(
        [
            1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * w * y + 2 * x * z,
            2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x,
            2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z, 1 - 2 * x * x - 2 * y * y,
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))
