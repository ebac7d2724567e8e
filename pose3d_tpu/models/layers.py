"""Plain ``jax.numpy`` layers and the init/apply contract of the lifters.

The lifters (``models/lifters.py``, ``models/temporal.py``) are written as
plain functions over nested parameter dicts, so the serving and temporal
paths need nothing beyond JAX itself. Each model is a frozen dataclass of
its hyperparameters with the two methods callers already use:

- ``init(rngs, x, train=...)`` -> ``{"params": ..., ["batch_stats": ...]}``;
- ``apply(variables, x, train=..., rngs=..., mutable=...)`` -> output, or
  ``(output, {"batch_stats": ...})`` when ``mutable`` is a list.

Parameter trees keep the names and shapes of the earlier ``flax.linen``
modules (``Dense_0/kernel``, ``LayerNorm_1/scale``, ``BatchNorm_0`` with
``mean``/``var`` running statistics), so saved params, the torch-weight
converters (``interop/torch_weights.py``) and the tests stay valid.

Numerics follow ``flax.linen``: a dense layer casts input and weights to the
compute dtype; LayerNorm and BatchNorm take their statistics in at least
float32 and return the compute dtype.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def dense_init(key, d_in: int, d_out: int, bias: bool = True) -> dict:
    p = {"kernel": _lecun_normal(key, (d_in, d_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((d_out,), jnp.float32)
    return p


def dense(p, x, dtype):
    """``x @ kernel + bias`` over the last axis, in ``dtype``."""
    x = x.astype(dtype)
    y = jax.lax.dot_general(x, p["kernel"].astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def norm_init(features: int) -> dict:
    return {"scale": jnp.ones((features,), jnp.float32),
            "bias": jnp.zeros((features,), jnp.float32)}


def _normalize(p, x, mean, var, eps, dtype):
    stat = mean.dtype
    y = (x.astype(stat) - mean) * (
        jax.lax.rsqrt(var + jnp.asarray(eps, stat)) * p["scale"].astype(stat))
    return (y + p["bias"].astype(stat)).astype(dtype)


def layer_norm(p, x, dtype, eps: float = 1e-5):
    """LayerNorm over the last axis; epsilon 1e-5 is torch's default, which
    the reference inherits."""
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(
        jnp.mean(jnp.square(xf), axis=-1, keepdims=True) - jnp.square(mean),
        0.0)
    return _normalize(p, xf, mean, var, eps, dtype)


def batch_stats_init(features: int) -> dict:
    return {"mean": jnp.zeros((features,), jnp.float32),
            "var": jnp.ones((features,), jnp.float32)}


def batch_moments(x):
    """Biased mean and variance over every axis but the last, in at least
    float32, and the element count ``n`` the reduction covered."""
    axes = tuple(range(x.ndim - 1))
    n = 1
    for a in axes:
        n *= x.shape[a]
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=axes)
    var = jnp.maximum(jnp.mean(jnp.square(xf), axis=axes) - jnp.square(mean),
                      0.0)
    return mean, var, n


def update_running(stats, mean, var, n, momentum):
    """torch's running-statistics update: the batch is normalised by the
    biased variance, ``running_var`` takes the unbiased one (x n/(n-1))."""
    unbiased = var * (n / max(n - 1, 1))
    return {"mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
            "var": momentum * stats["var"] + (1.0 - momentum) * unbiased}


def batch_norm(p, stats, x, *, train: bool, dtype, momentum: float = 0.9,
               eps: float = 1e-5):
    """torch ``BatchNorm1d`` semantics over the last axis (see
    ``models/norm.py`` for why they differ from flax's). Returns
    ``(y, new_stats)``; ``new_stats`` is ``stats`` when not training."""
    if train:
        mean, var, n = batch_moments(x)
        stats = update_running(stats, mean, var, n, momentum)
    else:
        mean, var = stats["mean"], stats["var"]
    return _normalize(p, x, mean, var, eps, dtype), stats


def dropout(x, rate: float, rng):
    """Inverted dropout; identity when ``rng`` is None (evaluation)."""
    if rng is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return jnp.zeros_like(x)
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


def attention(qkv, heads: int, dtype):
    """Multi-head self-attention core: (N, L, 3*D) packed q|k|v ->
    (N, L, D). Scores scaled by head_dim**-0.5; the softmax runs in at
    least float32 and its probabilities return to ``dtype``."""
    n, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (t.reshape(n, l, heads, dh).transpose(0, 2, 1, 3)
               for t in jnp.split(qkv, 3, axis=-1))
    s = jnp.einsum("nhld,nhmd->nhlm", q, k) * (dh ** -0.5)
    a = jax.nn.softmax(s.astype(out_dtype(dtype)), axis=-1).astype(dtype)
    out = jnp.einsum("nhlm,nhmd->nhld", a, v)
    return out.transpose(0, 2, 1, 3).reshape(n, l, d)


def out_dtype(dtype):
    """Models return at least float32 whatever their compute dtype."""
    return jnp.promote_types(dtype, jnp.float32)


@dataclasses.dataclass(frozen=True)
class Model:
    """Base of the plain-JAX lifters: subclasses define ``_init(key, x)``
    (returning the variables dict) and ``_forward(variables, x, train,
    rng)`` (returning ``(y, new_batch_stats)``)."""

    def init(self, rngs, x, train: bool = False) -> dict:
        del train
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        return self._init(key, jnp.asarray(x))

    def apply(self, variables, x, train: bool = False, rngs=None,
              mutable=False):
        rng = (rngs or {}).get("dropout") if train else None
        rate = getattr(self, "dropout", 0.0)
        if train and rate > 0.0 and rng is None:
            raise ValueError(
                f"{type(self).__name__}(dropout={rate}) in training "
                "needs rngs={'dropout': key}")
        y, stats = self._forward(variables, jnp.asarray(x), train, rng)
        if mutable is False:
            return y
        return y, ({"batch_stats": stats}
                   if "batch_stats" in mutable and stats is not None else {})
