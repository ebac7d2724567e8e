"""2D->3D keypoint lifting models, in plain ``jax.numpy``.

Equivalents of the reference lifter zoo (phase1_lifting/baselineModel.py):

- :class:`MartinezLifter`  <- ``LinearModel`` (baselineModel.py:50-102):
  Martinez-style residual MLP — Flatten -> Dense(1024) -> BN -> ReLU ->
  Dropout -> ``num_stages`` x residual block -> Dense(out). Each block
  (``MartinezBlock_i``, reference ``Linear``, baselineModel.py:14-47) is
  2x (Dense -> BN -> ReLU -> Dropout) + skip.
- :class:`AELifter`        <- ``AE`` (baselineModel.py:135-215): the active
  path is encoder2/decoder2 (1024-wide BN MLP).
- :class:`JointTransformerLifter` <- ``MyViT`` (baselineModel.py:312-362):
  17 joint tokens -> Dense to hidden 256 -> fixed (non-trainable) sinusoidal
  positional embedding -> 2 pre-LN transformer blocks (4 heads) -> per-token
  MLP 256 -> 128 -> out_d. The phase5 projector reuses it with
  ``in_dim=3, out_dim=2`` (train_5.py:63).

Behavioral notes kept for parity:
- the reference's Attention module (baselineModel.py:228-253, from lucidrains
  simple_vit) applies its own LayerNorm *in addition to* the block's pre-LN
  (baselineModel.py:308) — the double normalization is reproduced since it is
  what the trained reference computes; its qkv and output projections have
  no bias;
- positional embeddings use the reference's exact sin/cos formula
  (baselineModel.py:220-225) and are not trained (baselineModel.py:329-330);
- every LayerNorm uses epsilon 1e-5, the torch default the reference
  inherits (a 1e-6 epsilon was a real ~1e-6-relative forward divergence,
  caught by the f64 train-step parity tests in
  tests/test_reference_parity_train.py).

Compute dtype is configurable (bfloat16 for throughput, float32 params).
BatchNorm under data-parallel jit sees the full logical batch, so
cross-replica statistics come for free from GSPMD (SURVEY.md section 2.7).
The init/apply contract and parameter names are described in
``models/layers.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from pose3d_tpu.models import layers as L


def sinusoidal_positional_embeddings(sequence_length: int, d: int) -> np.ndarray:
    """Fixed PE with the reference's formula (baselineModel.py:220-225):
    pe[i, j] = sin(i / 1e4^(j/d)) for even j, cos(i / 1e4^((j-1)/d)) for odd j.
    """
    i = np.arange(sequence_length)[:, None].astype(np.float64)
    j = np.arange(d)[None, :].astype(np.float64)
    angle_even = i / np.power(1e4, j / d)
    angle_odd = i / np.power(1e4, (j - 1) / d)
    pe = np.where(j % 2 == 0, np.sin(angle_even), np.cos(angle_odd))
    return pe.astype(np.float32)


class _Sites:
    """Hands out one dropout key per dropout site (None when evaluating)."""

    def __init__(self, rng):
        self.rng, self.i = rng, 0

    def next(self):
        if self.rng is None:
            return None
        self.i += 1
        return jax.random.fold_in(self.rng, self.i)


def _unit_init(keys, params, stats, i, d_in, d_out, use_bn):
    params[f"Dense_{i}"] = L.dense_init(next(keys), d_in, d_out)
    if use_bn:
        params[f"BatchNorm_{i}"] = L.norm_init(d_out)
        stats[f"BatchNorm_{i}"] = L.batch_stats_init(d_out)


def _unit(params, stats, new_stats, i, y, model, train, sites):
    """Dense_i -> BatchNorm_i -> ReLU -> Dropout."""
    y = L.dense(params[f"Dense_{i}"], y, model.dtype)
    if model.use_bn:
        y, new_stats[f"BatchNorm_{i}"] = L.batch_norm(
            params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"], y,
            train=train, dtype=model.dtype)
    y = jax.nn.relu(y)
    return L.dropout(y, model.dropout, sites.next())


def _variables(params, stats, use_bn):
    return {"params": params, "batch_stats": stats} if use_bn else {
        "params": params}


@dataclasses.dataclass(frozen=True)
class MartinezLifter(L.Model):
    """Martinez-style residual-MLP lifter (reference ``LinearModel``).
    x: (B, 17, 2) or (B, in_dim) -> (B, out_dim)."""

    in_dim: int = 34           # 17 joints x 2
    out_dim: int = 51          # 17 joints x 3
    hidden: int = 1024
    num_stages: int = 2
    dropout: float = 0.5
    use_bn: bool = True
    dtype: Any = jnp.float32

    def _init(self, key, x):
        keys = iter(jax.random.split(key, 2 + 2 * self.num_stages))
        h = self.hidden
        params, stats = {}, {}
        _unit_init(keys, params, stats, 0, math.prod(x.shape[1:]), h,
                   self.use_bn)
        for s in range(self.num_stages):
            bp, bs = {}, {}
            for i in range(2):
                _unit_init(keys, bp, bs, i, h, h, self.use_bn)
            params[f"MartinezBlock_{s}"] = bp
            if self.use_bn:
                stats[f"MartinezBlock_{s}"] = bs
        params["Dense_1"] = L.dense_init(next(keys), h, self.out_dim)
        return _variables(params, stats, self.use_bn)

    def _forward(self, variables, x, train, rng):
        p = variables["params"]
        s = variables.get("batch_stats", {})
        new, sites = {}, _Sites(rng)
        y = x.reshape(x.shape[0], -1).astype(self.dtype)
        y = _unit(p, s, new, 0, y, self, train, sites)
        for b in range(self.num_stages):
            name = f"MartinezBlock_{b}"
            bs, bnew = s.get(name, {}), {}
            z = y
            for i in range(2):
                z = _unit(p[name], bs, bnew, i, z, self, train, sites)
            y = y + z
            if self.use_bn:
                new[name] = bnew
        y = L.dense(p["Dense_1"], y, self.dtype)
        return y.astype(L.out_dtype(self.dtype)), (new if self.use_bn
                                                   else None)


@dataclasses.dataclass(frozen=True)
class AELifter(L.Model):
    """Autoencoder lifter — the reference ``AE``'s active encoder2/decoder2
    path (baselineModel.py:186-215): Flatten -> [Dense(1024) BN ReLU Drop]x2
    -> Dense(1024) BN ReLU Drop -> Dense(out).

    Latent reference bug, documented not reproduced: the final Tanh
    (baselineModel.py:208,213-214) is DEAD CODE — the guard compares
    ``self.output_dim == 2`` after ``output_dim *= n_joints`` (34 != 2), so
    no trained reference AE ever applies it. Proven by the weight-transplant
    parity test (tests/test_reference_parity.py::test_ae_2d_output_no_tanh).
    """

    in_dim: int = 34
    out_dim: int = 51
    hidden: int = 1024
    dropout: float = 0.5
    dtype: Any = jnp.float32
    use_bn = True  # not a field: the reference AE always normalises

    def _init(self, key, x):
        keys = iter(jax.random.split(key, 4))
        params, stats = {}, {}
        d_in = math.prod(x.shape[1:])
        for i in range(3):  # encoder2 has 2 blocks, decoder2 one more
            _unit_init(keys, params, stats, i, d_in if i == 0 else self.hidden,
                       self.hidden, True)
        params["Dense_3"] = L.dense_init(next(keys), self.hidden,
                                         self.out_dim)
        return _variables(params, stats, True)

    def _forward(self, variables, x, train, rng):
        p, s = variables["params"], variables["batch_stats"]
        new, sites = {}, _Sites(rng)
        y = x.reshape(x.shape[0], -1).astype(self.dtype)
        for i in range(3):
            y = _unit(p, s, new, i, y, self, train, sites)
        y = L.dense(p["Dense_3"], y, self.dtype)
        return y.astype(L.out_dtype(self.dtype)), new


def _vit_block_init(key, dim: int, mlp_ratio: int = 4) -> dict:
    k = jax.random.split(key, 4)
    return {
        "LayerNorm_0": L.norm_init(dim),
        "JointAttention_0": {
            "LayerNorm_0": L.norm_init(dim),
            "Dense_0": L.dense_init(k[0], dim, 3 * dim, bias=False),
            "Dense_1": L.dense_init(k[1], dim, dim, bias=False),
        },
        "LayerNorm_1": L.norm_init(dim),
        "Dense_0": L.dense_init(k[2], dim, mlp_ratio * dim),
        "Dense_1": L.dense_init(k[3], mlp_ratio * dim, dim),
    }


def _vit_block(p, x, heads: int, dtype):
    """Pre-LN block (baselineModel.py:291-310): x + MHSA(LN(x));
    x + MLP(LN(x)) with exact GELU. MHSA applies its own LayerNorm first
    (the reference's double normalization)."""
    a = p["JointAttention_0"]
    y = L.layer_norm(a["LayerNorm_0"], L.layer_norm(p["LayerNorm_0"], x, dtype),
                     dtype)
    y = L.attention(L.dense(a["Dense_0"], y, dtype), heads, dtype)
    x = x + L.dense(a["Dense_1"], y, dtype)
    y = L.layer_norm(p["LayerNorm_1"], x, dtype)
    y = jax.nn.gelu(L.dense(p["Dense_0"], y, dtype), approximate=False)
    return x + L.dense(p["Dense_1"], y, dtype)


@dataclasses.dataclass(frozen=True)
class JointTransformerLifter(L.Model):
    """Joint-token transformer lifter (reference ``MyViT``).

    (B, n_joints, in_dim) -> (B, n_joints, out_dim). Defaults mirror
    baselineModel.py:313: 17 tokens, 2 blocks, hidden 256, 4 heads, out 3.
    """

    n_joints: int = 17
    in_dim: int = 2
    out_dim: int = 3
    hidden: int = 256
    n_blocks: int = 2
    heads: int = 4
    class_token: bool = False  # two2three.py:314-384 variant
    dtype: Any = jnp.float32

    def _init(self, key, x):
        k = jax.random.split(key, self.n_blocks + 4)
        h = self.hidden
        params = {
            "Dense_0": L.dense_init(k[0], x.shape[-1], h),
            "Dense_1": L.dense_init(k[1], h, h // 2),
            "Dense_2": L.dense_init(k[2], h // 2, self.out_dim),
        }
        if self.class_token:
            params["cls_token"] = 0.02 * jax.random.normal(
                k[3], (1, 1, h), jnp.float32)
        for i in range(self.n_blocks):
            params[f"TransformerBlock_{i}"] = _vit_block_init(k[4 + i], h)
        return {"params": params}

    def _forward(self, variables, x, train, rng):
        del train, rng  # no dropout/BN in the reference transformer path
        p, dt = variables["params"], self.dtype
        tokens = L.dense(p["Dense_0"], x, dt)
        if self.class_token:
            cls = jnp.broadcast_to(p["cls_token"].astype(dt),
                                   (x.shape[0], 1, self.hidden))
            tokens = jnp.concatenate([cls, tokens], axis=1)
        pe = sinusoidal_positional_embeddings(tokens.shape[1], self.hidden)
        tokens = tokens + jnp.asarray(pe, dtype=dt)
        for i in range(self.n_blocks):
            tokens = _vit_block(p[f"TransformerBlock_{i}"], tokens,
                                self.heads, dt)
        if self.class_token:
            tokens = tokens[:, 1:]
        y = jax.nn.relu(L.dense(p["Dense_1"], tokens, dt))
        y = L.dense(p["Dense_2"], y, dt)
        return y.astype(L.out_dtype(dt)), None
