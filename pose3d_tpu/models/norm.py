"""BatchNorm with torch-exact running-statistics semantics.

Every model in the reference is BatchNorm-heavy (Resnet.py:25-28,60-66,
baselineModel.py:25-28,70, Model.py deconv stacks), all with torch defaults:
momentum 0.1, eps 1e-5. ``flax.linen.BatchNorm`` differs from
``torch.nn.BatchNorm{1,2}d`` in one silent way that breaks train-step
numerical parity: torch normalizes the batch by the BIASED variance but
updates ``running_var`` with the UNBIASED variance (Bessel-corrected,
x n/(n-1)), while flax stores the biased variance. At batch 64 that is a
~1.6% per-update discrepancy in the running variance, compounding over an
epoch into an eval-time forward divergence.

This module is a drop-in replacement with torch semantics. The class is
deliberately named ``BatchNorm`` so flax auto-naming produces the same
``BatchNorm_k`` parameter paths as before — checkpoints and the torch
state-dict transplants (interop/torch_weights.py) are unaffected.

Cross-replica behavior under the mesh is inherited from GSPMD: the batch
reductions below are over the jit-global batch, so DP shards see global
statistics (proven against a single-device oracle in
tests/test_mesh_image.py). ``n`` for the Bessel correction is the global
reduction count (static shape), matching what torch would compute on the
same global batch on one device.

Train-step parity vs the actual torch modules (including these running-stat
updates) is proven by weight transplant in tests/test_reference_parity_train.py.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from flax import linen as nn

from pose3d_tpu.models.layers import batch_moments, update_running


class BatchNorm(nn.Module):
    """torch.nn.BatchNorm1d/2d semantics over the trailing feature axis.

    Differences from flax.linen.BatchNorm (all torch-parity driven):
    - running_var is updated with the unbiased batch variance
      (``var * n/(n-1)``, torch _BatchNorm.forward), while normalization
      uses the biased variance — exactly torch's train-mode split;
    - statistics and normalization are computed in float32 regardless of
      ``dtype`` (the compute dtype only shapes the returned activation).
    """

    use_running_average: bool
    momentum: float = 0.9      # flax convention: new = m*old + (1-m)*batch
    epsilon: float = 1e-5
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        features = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (features,),
                           jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (features,),
                          jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((features,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((features,), jnp.float32))

        # f32 statistics for bf16 activations; f64 passes through untouched
        # (the f64 train-parity tests run the whole model in double).
        stat_dtype = jnp.promote_types(x.dtype, jnp.float32)
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            # biased variance normalizes the batch (torch train path)
            mean, var, n = batch_moments(x)
            if not self.is_initializing():
                new = update_running(
                    {"mean": ra_mean.value, "var": ra_var.value}, mean, var,
                    n, self.momentum)
                ra_mean.value, ra_var.value = new["mean"], new["var"]

        y = (x.astype(stat_dtype) - mean) * jax.lax.rsqrt(
            var + jnp.asarray(self.epsilon, var.dtype))
        y = y * scale + bias
        return y.astype(self.dtype)
