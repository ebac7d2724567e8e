"""Temporal sequence lifter: spatial-temporal transformer over keypoint clips.

The reference delegates long-range temporal lifting to the external
MotionBERT repo (243-frame clips, invoked manually — phase2_opp_mb/
run.py:475-478; only the (T,17,3) npy outputs are consumed). This module is
the native implementation mandated by BASELINE config #3: a MotionBERT-style
alternating spatial/temporal attention transformer that lifts (B, T, 17, 2)
2D-keypoint clips to (B, T, 17, 3) 3D sequences. Plain ``jax.numpy``; the
init/apply contract and parameter names are described in
``models/layers.py``.

Architecture (MotionBERT/DSTformer family):
- joint tokens embedded to ``hidden``; learned spatial (17) and temporal (T)
  positional embeddings;
- each block runs attention over joints within a frame (sequence length 17,
  batch B*T) then attention over time per joint (sequence length T, batch
  B*17), each with a pre-LN MLP;
- at clip length 243 full temporal attention fits comfortably (243^2 scores);
  scale-out is batch sharding over the mesh (SURVEY.md section 5
  "long-context" note), with ``remat`` recomputing each block in the
  backward pass when memory needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from pose3d_tpu.models import layers as L


def _mhsa_init(key, dim: int) -> dict:
    k1, k2 = jax.random.split(key)
    return {"Dense_0": L.dense_init(k1, dim, 3 * dim),
            "Dense_1": L.dense_init(k2, dim, dim)}


def _mlp_init(key, dim: int, ratio: int = 4) -> dict:
    k1, k2 = jax.random.split(key)
    return {"Dense_0": L.dense_init(k1, dim, ratio * dim),
            "Dense_1": L.dense_init(k2, ratio * dim, dim)}


def _block_init(key, dim: int) -> dict:
    k = jax.random.split(key, 4)
    return {
        "_MHSA_0": _mhsa_init(k[0], dim), "LayerNorm_0": L.norm_init(dim),
        "_MLP_0": _mlp_init(k[1], dim), "LayerNorm_1": L.norm_init(dim),
        "_MHSA_1": _mhsa_init(k[2], dim), "LayerNorm_2": L.norm_init(dim),
        "_MLP_1": _mlp_init(k[3], dim), "LayerNorm_3": L.norm_init(dim),
    }


def _sub_block(p, x, mhsa, mlp, ln_a, ln_m, heads, dtype):
    """Pre-LN attention + MLP over the middle axis of (N, L, C)."""
    a = p[mhsa]
    y = L.dense(a["Dense_0"], L.layer_norm(p[ln_a], x, dtype), dtype)
    x = x + L.dense(a["Dense_1"], L.attention(y, heads, dtype), dtype)
    m = p[mlp]
    y = L.dense(m["Dense_0"], L.layer_norm(p[ln_m], x, dtype), dtype)
    return x + L.dense(m["Dense_1"], jax.nn.gelu(y, approximate=False), dtype)


def spatio_temporal_block(p, x, heads: int, dtype):
    """One ST block on (B, T, J, C): joint attention within frames
    (tokens = joints, batch = B*T), then time attention per joint
    (tokens = frames, batch = B*J); pre-LN residual throughout."""
    b, t, j, c = x.shape
    xs = _sub_block(p, x.reshape(b * t, j, c), "_MHSA_0", "_MLP_0",
                    "LayerNorm_0", "LayerNorm_1", heads, dtype)
    xt = xs.reshape(b, t, j, c).transpose(0, 2, 1, 3).reshape(b * j, t, c)
    xt = _sub_block(p, xt, "_MHSA_1", "_MLP_1", "LayerNorm_2", "LayerNorm_3",
                    heads, dtype)
    return xt.reshape(b, j, t, c).transpose(0, 2, 1, 3)


@dataclasses.dataclass(frozen=True)
class TemporalLifter(L.Model):
    """(B, T, 17, 2) -> (B, T, 17, 3) sequence lifting."""

    n_joints: int = 17
    in_dim: int = 2
    out_dim: int = 3
    clip_len: int = 243
    hidden: int = 256
    n_blocks: int = 5
    heads: int = 8
    remat: bool = False
    # Sequence parallelism (long clips): a PartitionSpec-style tuple for the
    # (B, T, J, C) activations, e.g. ("data", "seq", None, None). Applied as
    # GSPMD sharding constraints after the embedding and between blocks; XLA
    # inserts the all-gathers the temporal attention needs. Requires an
    # ambient mesh (jax.sharding.set_mesh). None = no constraint.
    activation_spec: tuple | None = None
    dtype: Any = jnp.float32

    def _constrain(self, x):
        if self.activation_spec is None:
            return x
        from jax.sharding import PartitionSpec as P

        return jax.lax.with_sharding_constraint(x, P(*self.activation_spec))

    def _init(self, key, x):
        k = jax.random.split(key, self.n_blocks + 5)
        h = self.hidden
        params = {
            "Dense_0": L.dense_init(k[0], x.shape[-1], h),
            "spatial_pe": 0.02 * jax.random.normal(
                k[1], (1, 1, self.n_joints, h), jnp.float32),
            "temporal_pe": 0.02 * jax.random.normal(
                k[2], (1, self.clip_len, 1, h), jnp.float32),
            "LayerNorm_0": L.norm_init(h),
            "Dense_1": L.dense_init(k[3], h, h // 2),
            "Dense_2": L.dense_init(k[4], h // 2, self.out_dim),
        }
        for i in range(self.n_blocks):
            params[f"SpatioTemporalBlock_{i}"] = _block_init(k[5 + i], h)
        return {"params": params}

    def _forward(self, variables, x, train, rng):
        del train, rng
        p, dt = variables["params"], self.dtype
        t = x.shape[1]
        assert t <= self.clip_len, (t, self.clip_len)
        x = L.dense(p["Dense_0"], x, dt)
        x = (x + p["spatial_pe"].astype(dt)
             + p["temporal_pe"][:, :t].astype(dt))
        x = self._constrain(x)
        block = spatio_temporal_block
        if self.remat:
            block = jax.checkpoint(block, static_argnums=(2, 3))
        for i in range(self.n_blocks):
            x = self._constrain(
                block(p[f"SpatioTemporalBlock_{i}"], x, self.heads, dt))
        x = L.layer_norm(p["LayerNorm_0"], x, dt)
        y = jax.nn.relu(L.dense(p["Dense_1"], x, dt))
        return L.dense(p["Dense_2"], y, dt).astype(jnp.float32), None


def clip_starts(n: int, clip_len: int, stride: int) -> list:
    """Start offsets of sliding windows COVERING every frame: the regular
    stride grid plus, when the grid's last window ends before frame n, a
    final window anchored at n - clip_len. Without that anchor, any
    sequence with (n - clip_len) % stride != 0 leaves its tail frames in
    no clip at all (e.g. 438 frames, clip 243, stride 121: the grid stops
    at start 121, frames 364..437 uncovered)."""
    starts = list(range(0, max(n - clip_len + 1, 1), stride))
    if starts[-1] + clip_len < n:
        starts.append(max(n - clip_len, 0))
    return starts


def make_clips(sequence, clip_len: int = 243, stride: int | None = None):
    """Host-side: (N, J, D) frame sequence -> (num_clips, clip_len, J, D)
    sliding windows (stride defaults to clip_len, i.e. non-overlapping; the
    MotionBERT convention for training windows). Every frame is covered
    (see ``clip_starts``); a too-short tail clip is padded by repeating
    the last frame."""
    import numpy as np

    stride = stride or clip_len
    n = sequence.shape[0]
    clips = []
    for s in clip_starts(n, clip_len, stride):
        clip = sequence[s : s + clip_len]
        if len(clip) < clip_len:  # pad the tail clip by repeating last frame
            pad = np.repeat(clip[-1:], clip_len - len(clip), axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        clips.append(clip)
    return np.stack(clips, axis=0)
