"""The plain-XLA paths against float64 numpy references.

Every model and op the GPU runs is what XLA makes of ``models/layers.py``,
``models/lifters.py``, ``models/temporal.py`` and ``ops/heatmap.py``. Each is
checked here against an independent numpy implementation of the same math in
float64: attention over joints (L=17), over time (L=243) and at odd lengths,
for every head count the models use; the lifter and temporal blocks and
whole models; the NHWC soft-argmax decode with its gradients against finite
differences; the Martinez lifter with BatchNorm statistics; and the
clip-averaging of ``lift_sequence``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erf

from pose3d_tpu.models import layers as L
from pose3d_tpu.models.lifters import (
    AELifter,
    JointTransformerLifter,
    MartinezLifter,
    _vit_block,
    sinusoidal_positional_embeddings,
)
from pose3d_tpu.models.temporal import (
    TemporalLifter,
    clip_starts,
    spatio_temporal_block,
)
from pose3d_tpu.ops.heatmap import soft_argmax_3d, soft_argmax_3d_nhwc


def close(got, ref, rtol=2e-4):
    """float32 against a float64 reference: agreement to a few float32
    roundings of the output scale."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-12))


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


# ---------------------------------------------------------------- numpy math

def np_dense(p, x):
    return x @ p["kernel"] + (p["bias"] if "bias" in p else 0.0)


def np_ln(p, x, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * p["scale"] + p["bias"]


def np_gelu(x):
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def np_softmax(s):
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def np_attention(qkv, heads):
    n, l, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(n, l, heads, d // heads).transpose(0, 2, 1, 3)
               for t in np.split(qkv, 3, axis=-1))
    a = np_softmax(q @ k.transpose(0, 1, 3, 2) * (d // heads) ** -0.5)
    return (a @ v).transpose(0, 2, 1, 3).reshape(n, l, d)


def np_vit_block(p, x, heads):
    a = p["JointAttention_0"]
    y = np_ln(a["LayerNorm_0"], np_ln(p["LayerNorm_0"], x))
    x = x + np_dense(a["Dense_1"], np_attention(np_dense(a["Dense_0"], y),
                                                heads))
    y = np_gelu(np_dense(p["Dense_0"], np_ln(p["LayerNorm_1"], x)))
    return x + np_dense(p["Dense_1"], y)


def np_vit(p, x, heads, n_blocks, class_token):
    t = np_dense(p["Dense_0"], x)
    if class_token:
        cls = np.broadcast_to(p["cls_token"], (x.shape[0], 1, t.shape[-1]))
        t = np.concatenate([cls, t], 1)
    t = t + sinusoidal_positional_embeddings(t.shape[1], t.shape[-1])
    for i in range(n_blocks):
        t = np_vit_block(p[f"TransformerBlock_{i}"], t, heads)
    if class_token:
        t = t[:, 1:]
    return np_dense(p["Dense_2"], np.maximum(np_dense(p["Dense_1"], t), 0))


def np_sub_block(p, x, mhsa, mlp, ln_a, ln_m, heads):
    y = np_dense(p[mhsa]["Dense_0"], np_ln(p[ln_a], x))
    x = x + np_dense(p[mhsa]["Dense_1"], np_attention(y, heads))
    y = np_gelu(np_dense(p[mlp]["Dense_0"], np_ln(p[ln_m], x)))
    return x + np_dense(p[mlp]["Dense_1"], y)


def np_st_block(p, x, heads):
    b, t, j, c = x.shape
    xs = np_sub_block(p, x.reshape(b * t, j, c), "_MHSA_0", "_MLP_0",
                      "LayerNorm_0", "LayerNorm_1", heads)
    xt = xs.reshape(b, t, j, c).transpose(0, 2, 1, 3).reshape(b * j, t, c)
    xt = np_sub_block(p, xt, "_MHSA_1", "_MLP_1", "LayerNorm_2",
                      "LayerNorm_3", heads)
    return xt.reshape(b, j, t, c).transpose(0, 2, 1, 3)


def np_temporal(p, x, heads, n_blocks):
    t = x.shape[1]
    h = np_dense(p["Dense_0"], x) + p["spatial_pe"] + p["temporal_pe"][:, :t]
    for i in range(n_blocks):
        h = np_st_block(p[f"SpatioTemporalBlock_{i}"], h, heads)
    h = np.maximum(np_dense(p["Dense_1"], np_ln(p["LayerNorm_0"], h)), 0)
    return np_dense(p["Dense_2"], h)


def np_bn(p, stats, x, train, momentum=0.9, eps=1e-5):
    if train:
        mean, var = x.mean(0), x.var(0)
        n = x.shape[0]
        stats = {"mean": momentum * stats["mean"] + (1 - momentum) * mean,
                 "var": momentum * stats["var"]
                 + (1 - momentum) * var * n / (n - 1)}
    else:
        mean, var = stats["mean"], stats["var"]
    return (x - mean) / np.sqrt(var + eps) * p["scale"] + p["bias"], stats


def np_martinez(p, s, x, num_stages, train):
    new = {}

    def unit(pp, ss, nn, i, y):
        y = np_dense(pp[f"Dense_{i}"], y)
        y, nn[f"BatchNorm_{i}"] = np_bn(pp[f"BatchNorm_{i}"],
                                        ss[f"BatchNorm_{i}"], y, train)
        return np.maximum(y, 0)

    y = unit(p, s, new, 0, x.reshape(x.shape[0], -1))
    for b in range(num_stages):
        name, bnew = f"MartinezBlock_{b}", {}
        z = y
        for i in range(2):
            z = unit(p[name], s[name], bnew, i, z)
        y, new[name] = y + z, bnew
    return np_dense(p["Dense_1"], y), new


def np_soft_argmax_nhwc(logits, j, d, z_scale=2.5):
    b, h, w, _ = logits.shape
    x = logits.reshape(b, h, w, j, d).transpose(0, 3, 1, 2, 4)
    p = np_softmax(x.reshape(b, j, -1)).reshape(b, j, h, w, d)
    ex = (p.sum((2, 4)) * np.arange(w)).sum(-1)
    ey = (p.sum((3, 4)) * np.arange(h)).sum(-1)
    ez = (p.sum((2, 3)) * np.arange(d)).sum(-1)
    c = np.stack([(ex / w - .5) * 2, (ey / h - .5) * 2,
                  (ez / d - .5) * z_scale], -1)
    return c.reshape(b, j * 3)


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("seq", [17, 243, 5, 31])
@pytest.mark.parametrize("heads", [1, 2, 4, 8])
def test_attention_core(rng, seq, heads):
    """Joint tokens (17), temporal clip (243) and odd lengths; head counts
    of the lifter (4), the temporal model (8) and the small configs."""
    qkv = rng.standard_normal((3, seq, 3 * 64))
    got = L.attention(jnp.asarray(qkv, jnp.float32), heads, jnp.float32)
    close(got, np_attention(qkv, heads))


@pytest.mark.parametrize("seq,heads", [(17, 4), (17, 2), (18, 4), (5, 1),
                                       (31, 8)])
def test_joint_attention_block(rng, seq, heads):
    """The lifter's pre-LN block, with the reference's double LayerNorm in
    front of the bias-free qkv projection."""
    dim = 32
    p = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        L_vit_params(dim))
    x = rng.standard_normal((4, seq, dim)).astype(np.float32)
    got = _vit_block(p, jnp.asarray(x), heads, jnp.float32)
    close(got, np_vit_block(f64(p), x.astype(np.float64), heads))


def L_vit_params(dim):
    from pose3d_tpu.models.lifters import _vit_block_init

    return _vit_block_init(jax.random.key(0), dim)


@pytest.mark.parametrize("cfg", [
    dict(hidden=32, n_blocks=1, heads=2),
    dict(hidden=32, n_blocks=2, heads=4),
    dict(hidden=32, n_blocks=1, heads=2, class_token=True),
    dict(hidden=32, n_blocks=1, heads=2, in_dim=3, out_dim=2),
])
def test_joint_transformer_lifter(rng, cfg):
    model = JointTransformerLifter(**cfg)
    x = rng.standard_normal((6, 17, model.in_dim)).astype(np.float32)
    p = model.init(jax.random.key(1), jnp.asarray(x))["params"]
    got = model.apply({"params": p}, jnp.asarray(x))
    close(got, np_vit(f64(p), x.astype(np.float64), model.heads,
                      model.n_blocks, model.class_token))


@pytest.mark.parametrize("t,heads", [(243, 8), (27, 4), (5, 2), (13, 1)])
def test_spatio_temporal_block(rng, t, heads):
    """Spatial attention over 17 joints, then temporal attention over t
    frames per joint."""
    from pose3d_tpu.models.temporal import _block_init

    dim = 32
    p = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        _block_init(jax.random.key(2), dim))
    x = rng.standard_normal((1, t, 17, dim)).astype(np.float32)
    got = spatio_temporal_block(p, jnp.asarray(x), heads, jnp.float32)
    close(got, np_st_block(f64(p), x.astype(np.float64), heads))


@pytest.mark.parametrize("remat", [False, True])
def test_temporal_lifter(rng, remat):
    model = TemporalLifter(clip_len=12, hidden=32, n_blocks=2, heads=4,
                           remat=remat)
    x = rng.standard_normal((2, 9, 17, 2)).astype(np.float32)
    p = model.init(jax.random.key(3), jnp.asarray(x))["params"]
    close(model.apply({"params": p}, jnp.asarray(x)),
          np_temporal(f64(p), x.astype(np.float64), 4, 2))


def test_temporal_remat_gradient_matches(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 17, 2)), jnp.float32)
    plain = TemporalLifter(clip_len=8, hidden=32, n_blocks=2, heads=2)
    p = plain.init(jax.random.key(4), x)["params"]

    def grads(model):
        return jax.grad(lambda q: jnp.sum(
            model.apply({"params": q}, x) ** 2))(p)

    for a, b in zip(jax.tree_util.tree_leaves(grads(plain)),
                    jax.tree_util.tree_leaves(grads(
                        TemporalLifter(clip_len=8, hidden=32, n_blocks=2,
                                       heads=2, remat=True)))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- soft-argmax

@pytest.mark.parametrize("j", [17, 4, 3])
@pytest.mark.parametrize("hw,d", [(8, 8), (16, 4)])
def test_soft_argmax_nhwc_forward(rng, j, hw, d):
    logits = rng.standard_normal((2, hw, hw, j * d)) * 3
    got = soft_argmax_3d_nhwc(jnp.asarray(logits, jnp.float32), j, d)
    close(got, np_soft_argmax_nhwc(logits, j, d))


@pytest.mark.parametrize("j", [17, 4, 3])
def test_soft_argmax_nhwc_matches_transpose_path(rng, j):
    b, h, w, d = 2, 8, 12, 6
    logits = jnp.asarray(rng.standard_normal((b, h, w, j * d)), jnp.float32)
    ref, _ = soft_argmax_3d(
        logits.transpose(0, 3, 1, 2).reshape(b, j, d, h, w), j, d, h, w,
        return_heatmap=False)
    close(soft_argmax_3d_nhwc(logits, j, d), ref)


@pytest.mark.parametrize("z_scale", [2.5, 2.0, 1.0])
def test_soft_argmax_nhwc_z_scale(rng, z_scale):
    logits = rng.standard_normal((1, 8, 8, 17 * 8))
    got = soft_argmax_3d_nhwc(jnp.asarray(logits, jnp.float32), 17, 8,
                              z_scale=z_scale)
    close(got, np_soft_argmax_nhwc(logits, 17, 8, z_scale))


def test_soft_argmax_nhwc_bf16_logits(rng):
    logits = rng.standard_normal((2, 8, 8, 17 * 8)) * 3
    got = soft_argmax_3d_nhwc(jnp.asarray(logits, jnp.bfloat16), 17, 8)
    assert got.dtype == jnp.float32
    ref = np_soft_argmax_nhwc(
        np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float64), 17, 8)
    close(got, ref)


@pytest.mark.parametrize("j", [17, 4, 3])
def test_soft_argmax_nhwc_gradient_finite_differences(rng, j):
    """Directional derivatives of sum(w * coords) against central
    differences of the float64 reference."""
    hw, d = 8, 4
    logits = rng.standard_normal((2, hw, hw, j * d))
    wts = rng.standard_normal((2, j * 3))

    def f(x):
        return jnp.sum(jnp.asarray(wts, jnp.float32)
                       * soft_argmax_3d_nhwc(x, j, d))

    g = np.asarray(jax.grad(f)(jnp.asarray(logits, jnp.float32)), np.float64)
    for _ in range(3):
        v = rng.standard_normal(logits.shape)
        eps = 1e-4
        fd = (np.sum(wts * np_soft_argmax_nhwc(logits + eps * v, j, d))
              - np.sum(wts * np_soft_argmax_nhwc(logits - eps * v, j, d))
              ) / (2 * eps)
        np.testing.assert_allclose(np.sum(g * v), fd, rtol=1e-3, atol=1e-5)


# --------------------------------------------------------- Martinez with BN

def _bn_variables(model, x, rng):
    v = model.init(jax.random.key(5), jnp.asarray(x))
    # nontrivial running statistics and affine params
    return jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.3 * rng.standard_normal(a.shape)).astype(
            np.float32) if a.ndim == 1 else a, v)


@pytest.mark.parametrize("num_stages", [1, 2, 3])
def test_martinez_eval_with_batch_stats(rng, num_stages):
    model = MartinezLifter(hidden=64, num_stages=num_stages)
    x = rng.standard_normal((8, 17, 2)).astype(np.float32)
    v = _bn_variables(model, x, rng)
    got = model.apply(v, jnp.asarray(x), train=False)
    ref, _ = np_martinez(f64(v["params"]), f64(v["batch_stats"]),
                         x.astype(np.float64), num_stages, train=False)
    close(got, ref)


@pytest.mark.parametrize("num_stages", [1, 2])
def test_martinez_train_updates_running_stats(rng, num_stages):
    """Batch statistics normalise, the unbiased variance updates the
    running estimate (torch semantics); dropout off."""
    model = MartinezLifter(hidden=64, num_stages=num_stages, dropout=0.0)
    x = rng.standard_normal((16, 17, 2)).astype(np.float32)
    v = _bn_variables(model, x, rng)
    got, upd = model.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    ref, ref_stats = np_martinez(f64(v["params"]), f64(v["batch_stats"]),
                                 x.astype(np.float64), num_stages, train=True)
    close(got, ref, rtol=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(upd["batch_stats"]),
                    jax.tree_util.tree_leaves(ref_stats)):
        close(a, b, rtol=1e-3)


def test_martinez_without_bn(rng):
    model = MartinezLifter(hidden=64, use_bn=False, dropout=0.0)
    x = rng.standard_normal((4, 34)).astype(np.float32)
    v = model.init(jax.random.key(6), jnp.asarray(x))
    assert "batch_stats" not in v
    p = f64(v["params"])
    y = np.maximum(np_dense(p["Dense_0"], x.astype(np.float64)), 0)
    for b in range(2):
        z = y
        for i in range(2):
            z = np.maximum(np_dense(p[f"MartinezBlock_{b}"][f"Dense_{i}"], z),
                           0)
        y = y + z
    close(model.apply(v, jnp.asarray(x)), np_dense(p["Dense_1"], y))


def test_ae_eval_with_batch_stats(rng):
    model = AELifter(hidden=64)
    x = rng.standard_normal((8, 17, 2)).astype(np.float32)
    v = _bn_variables(model, x, rng)
    p, s = f64(v["params"]), f64(v["batch_stats"])
    y = x.reshape(8, -1).astype(np.float64)
    for i in range(3):
        y, _ = np_bn(p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"],
                     np_dense(p[f"Dense_{i}"], y), train=False)
        y = np.maximum(y, 0)
    close(model.apply(v, jnp.asarray(x)), np_dense(p["Dense_3"], y))


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_dropout(rng, rate):
    x = jnp.ones((4000,))
    y = np.asarray(L.dropout(x, rate, jax.random.key(0)))
    if rate == 1.0:
        assert not y.any()
        return
    kept = y != 0
    np.testing.assert_allclose(y[kept], 1.0 / (1.0 - rate))
    assert abs(kept.mean() - (1.0 - rate)) < 0.03
    assert np.array_equal(np.asarray(L.dropout(x, rate, None)), x)


def test_dropout_needs_a_key_in_training():
    model = MartinezLifter(hidden=16)
    v = model.init(jax.random.key(0), jnp.zeros((2, 34)))
    with pytest.raises(ValueError, match="dropout"):
        model.apply(v, jnp.zeros((2, 34)), train=True,
                    mutable=["batch_stats"])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm(rng, dtype):
    x = rng.standard_normal((5, 7, 48)) * 4 + 2
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    got = L.layer_norm(p, jnp.asarray(x, dtype), dtype)
    assert got.dtype == dtype
    xin = np.asarray(jnp.asarray(x, dtype), np.float64)
    close(got, np_ln(f64(p), xin), rtol=2e-4 if dtype == jnp.float32
          else 1e-2)


# ------------------------------------------------- lift_sequence coverage

@pytest.mark.parametrize("t_total,stride", [(5, None), (16, None), (17, None),
                                            (30, None), (43, None),
                                            (100, None), (43, 5), (100, 16)])
def test_lift_sequence_averages_every_frame(rng, t_total, stride):
    """Every frame is covered; each is the mean over the clips that hold
    it, including the tail clip anchored at the end."""
    from pose3d_tpu.pipeline.lift import lift_sequence

    model = TemporalLifter(clip_len=16, hidden=32, n_blocks=1, heads=2)
    p = model.init(jax.random.key(7), jnp.zeros((1, 16, 17, 2)))["params"]
    kp = (rng.random((t_total, 17, 2)) * 1000).astype(np.float32)
    got = lift_sequence(p, model, kp, stride=stride)

    clip_len = min(16, t_total)
    stride = stride or max(clip_len // 2, 1)
    acc = np.zeros((t_total, 17, 3))
    cnt = np.zeros((t_total, 1, 1))
    starts = clip_starts(t_total, clip_len, stride)
    assert starts[-1] + clip_len >= t_total
    for s in starts:
        clip = kp[s:s + clip_len] / 1000.0
        out = np.asarray(model.apply({"params": p}, jnp.asarray(clip[None])))
        acc[s:s + clip_len] += out[0]
        cnt[s:s + clip_len] += 1
    assert cnt.min() >= 1
    close(got, acc / cnt, rtol=1e-5)
