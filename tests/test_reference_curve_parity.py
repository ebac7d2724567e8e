"""Multi-epoch MPJPE CURVE parity vs the actual reference trainer.

The strongest MPJPE-parity evidence obtainable without the real H3.6M
export: train the phase-1 lifter for dozens of epochs on IDENTICAL
fabricated H36M-format data with IDENTICAL hyperparameters — the reference
loop body reproduced verbatim from phase1_lifting/train_1.py (MSE,
AdamW(lr) with torch defaults, ReduceLROnPlateau(factor .7, patience 3,
cooldown 2, min_lr 5e-6) stepped with the LAST train batch's loss
(train_1.py:106), MPJPE accumulated as loss_MPJPE/len(dataset) then
mean(joints 1:) x (17/16) x 1000, train_1.py:100-104) — against this
framework's jitted TrainState pipeline, and assert the per-epoch MPJPE-mm
trajectories track within a stated band.

Determinism notes:
- batch ORDER is fixed identically on both sides (the reference shuffles;
  shuffling order is framework-RNG-specific, and curve parity is only
  meaningful on identical batch sequences);
- MyViT has no dropout/BatchNorm => the torch side is bit-deterministic;
  the Martinez case runs dropout 0 with BatchNorm ACTIVE, so the running
  statistics compound over the whole run and the eval-mode validation
  curve checks them end-to-end.

Precision: the comparison runs in FLOAT64 on both sides. In f32,
per-step reduction-order noise (~1e-7 relative) compounds at ~x1.03/step
through the nonconvex optimization — measured: the two f32 curves track to
<0.5% for ~20 epochs, then drift to 15-30% by epoch 60 (FP-chaos, NOT a
math divergence; the f64 agreement here plus the f64 one-step tests in
test_reference_parity_train.py are the proof). In f64 the same 240-step
horizon amplifies ~1e-15 noise to at most ~1e-9, so the band below is
tight. lr = 2^-10 keeps the f32 plateau-lr state exact.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_reference_parity import PHASE1, ref_module  # noqa: E402

from pose3d_tpu import losses  # noqa: E402
from pose3d_tpu.interop import (  # noqa: E402
    martinez_from_torch,
    vit_lifter_from_torch,
)
from pose3d_tpu.models.lifters import (  # noqa: E402
    JointTransformerLifter,
    MartinezLifter,
)
from pose3d_tpu.train.schedule import plateau_init  # noqa: E402
from pose3d_tpu.train.state import TrainState, make_optimizer  # noqa: E402
from pose3d_tpu.train.steps import (  # noqa: E402
    make_lifter_eval_step,
    make_lifter_train_step,
    plateau_step,
)

pytestmark = pytest.mark.skipif(
    not PHASE1.exists(), reason="reference checkout not present"
)


@pytest.fixture(scope="module", autouse=True)
def enable_x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def fabricate_h36m(n: int, seed: int, noise: float = 0.02):
    """Learnable fabricated data in the H36M trainer's format: zero-centred
    standardized-scale 3D poses; 2D = orthographic (x,y) + noise. The task
    is genuinely learnable, so MPJPE falls like a real curve. Values are
    f32-representable (cast through f32) then carried in f64."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 17, 3)).astype(np.float32) * 0.6
    y3 = base + rng.standard_normal((n, 17, 3)).astype(np.float32) * 0.35
    y3 = y3 - y3[:, :1]  # zero-centre the root (H36_dataset zero_centre)
    y2 = y3[..., :2] + rng.standard_normal((n, 17, 2)).astype(np.float32) * noise
    return y2.astype(np.float64), y3.astype(np.float64)


def epoch_mpjpe_mm(per_joint_sums, n):
    m = np.mean(per_joint_sums[1:17] / n)
    return m * (17.0 / 16.0) * 1000.0  # train_1.py:102-104


def run_torch_curve(tmodel, y2, y3, vy2, vy3, batch, epochs, lr):
    """The train_1.py loop body, epoch-for-epoch (citations inline)."""
    opt = torch.optim.AdamW(tmodel.parameters(), lr=lr)  # train_1.py:39
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(   # train_1.py:41
        opt, factor=0.7, patience=3, cooldown=2, min_lr=5e-6
    )
    n, nv = len(y2), len(vy2)
    curve, vcurve, lrs = [], [], []
    for _ in range(epochs):
        tmodel.train()
        sums = torch.zeros(17, dtype=torch.float64)
        loss = None
        for s in range(0, n, batch):
            x = torch.from_numpy(y2[s:s + batch])
            y = torch.from_numpy(y3[s:s + batch])
            opt.zero_grad()
            pred = tmodel(x).reshape(y.shape)        # train_1.py:87-88
            loss = torch.nn.MSELoss(reduction="mean")(pred, y)
            loss.backward()                          # train_1.py:94-95
            opt.step()                               # train_1.py:96
            with torch.no_grad():                    # loss_MPJPE, :19-23
                sums += torch.norm(pred - y, dim=-1).sum(0)
        sched.step(loss)                             # train_1.py:106
        curve.append(epoch_mpjpe_mm(sums.numpy(), n))
        lrs.append(opt.param_groups[0]["lr"])
        tmodel.eval()
        with torch.no_grad():
            vsums = torch.zeros(17, dtype=torch.float64)
            for s in range(0, nv, batch):
                x = torch.from_numpy(vy2[s:s + batch])
                y = torch.from_numpy(vy3[s:s + batch])
                pred = tmodel(x).reshape(y.shape)
                vsums += torch.norm(pred - y, dim=-1).sum(0)
        vcurve.append(epoch_mpjpe_mm(vsums.numpy(), nv))
    return np.array(curve), np.array(vcurve), np.array(lrs)


def run_jax_curve(model, variables, y2, y3, vy2, vy3, batch, epochs, lr):
    tx = make_optimizer(lr, "adamw")
    state = TrainState(
        step=jnp.asarray(0, jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        plateau=plateau_init(lr), tx=tx, apply_fn=model.apply,
    )
    step = make_lifter_train_step("mse", donate=False)
    eval_step = make_lifter_eval_step("mse")
    n, nv = len(y2), len(vy2)
    curve, vcurve, lrs = [], [], []
    for _ in range(epochs):
        sums = np.zeros(17)
        metrics = None
        for s in range(0, n, batch):
            state, metrics = step(
                state, jnp.asarray(y2[s:s + batch]),
                jnp.asarray(y3[s:s + batch]), jax.random.key(0),
            )
            sums += np.asarray(metrics["mpjpe_sums"])
        state = plateau_step(state, metrics["loss"])
        curve.append(epoch_mpjpe_mm(sums, n))
        lrs.append(float(state.plateau.lr))
        vsums = np.zeros(17)
        for s in range(0, nv, batch):
            m = eval_step(state, jnp.asarray(vy2[s:s + batch]),
                          jnp.asarray(vy3[s:s + batch]))
            vsums += np.asarray(m["mpjpe_sums"])
        vcurve.append(epoch_mpjpe_mm(vsums, nv))
    return np.array(curve), np.array(vcurve), np.array(lrs)


def assert_curves_track(ours, ref, rel, label):
    ref_floor = np.maximum(np.abs(ref), 1e-3)
    rel_err = np.abs(ours - ref) / ref_floor
    assert rel_err.max() < rel, (
        f"{label}: max relative divergence {rel_err.max():.4%} at epoch "
        f"{int(rel_err.argmax())} (ours={ours[rel_err.argmax()]:.4f} "
        f"ref={ref[rel_err.argmax()]:.4f})"
    )


class TestCurveParity:
    EPOCHS = 30
    BATCH = 64
    LR = 2.0 ** -10  # exactly representable in f32 (the plateau-lr state)

    @pytest.mark.slow

    def test_vit_lifter_curve_parity(self, monkeypatch):
        """30 epochs of the committed phase-1 model (MyViT, train_1.py:35)
        on identical fabricated data: MPJPE(train), MPJPE(val) and the
        plateau-lr trajectory all track the reference."""
        y2, y3 = fabricate_h36m(512, seed=0)
        vy2, vy3 = fabricate_h36m(128, seed=1)

        bm = ref_module("baselineModel", PHASE1)
        torch.manual_seed(20)
        tm = bm.MyViT(chw=(1, 17, 2), out_d=3).double()
        tm.train()
        sd0 = {k: v.detach().clone() for k, v in tm.state_dict().items()}
        curve_t, vcurve_t, lrs_t = run_torch_curve(
            tm, y2, y3, vy2, vy3, self.BATCH, self.EPOCHS, self.LR
        )

        # bit-align the fixed PE with the reference buffer (see
        # test_reference_parity_train); a one-ulp PE difference would seed
        # the chaotic divergence this f64 test exists to exclude
        import pose3d_tpu.models.lifters as lifters_mod

        pe = tm.pos_embed.detach().numpy().reshape(17, 256)
        monkeypatch.setattr(lifters_mod, "sinusoidal_positional_embeddings",
                            lambda s, d: pe)

        model = JointTransformerLifter(dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), vit_lifter_from_torch(sd0)
        )
        curve_j, vcurve_j, lrs_j = run_jax_curve(
            model, variables, y2, y3, vy2, vy3,
            self.BATCH, self.EPOCHS, self.LR,
        )

        # the curve must actually be a training curve, not noise
        assert curve_t[-1] < 0.5 * curve_t[0]
        assert_curves_track(curve_j, curve_t, 1e-3, "MPJPE(train)")
        assert_curves_track(vcurve_j, vcurve_t, 1e-3, "MPJPE(val)")
        np.testing.assert_allclose(lrs_j, lrs_t, rtol=1e-6,
                                   err_msg="plateau-lr trajectories")

    @pytest.mark.slow

    def test_martinez_curve_parity_with_batchnorm(self):
        """30 epochs of the Martinez lifter with BatchNorm ACTIVE
        (dropout 0): the eval-mode validation curve depends on the running
        statistics compounded over every train step — an end-to-end check
        of the torch BN semantics (momentum 0.1, unbiased running var)."""
        epochs = 25
        y2, y3 = fabricate_h36m(512, seed=2)
        vy2, vy3 = fabricate_h36m(128, seed=3)

        bm = ref_module("baselineModel", PHASE1)
        torch.manual_seed(21)
        tm = bm.LinearModel(i_dim=34, o_dim=51, p_dropout=0.0).double()
        tm.train()
        sd0 = {k: v.detach().clone() for k, v in tm.state_dict().items()}
        curve_t, vcurve_t, lrs_t = run_torch_curve(
            tm, y2, y3, vy2, vy3, self.BATCH, epochs, self.LR
        )

        model = MartinezLifter(dropout=0.0, dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), martinez_from_torch(sd0)
        )
        curve_j, vcurve_j, lrs_j = run_jax_curve(
            model, variables, y2, y3, vy2, vy3, self.BATCH, epochs, self.LR
        )

        assert curve_t[-1] < 0.5 * curve_t[0]
        assert_curves_track(curve_j, curve_t, 1e-3, "MPJPE(train)")
        assert_curves_track(vcurve_j, vcurve_t, 1e-3, "MPJPE(val)")
        np.testing.assert_allclose(lrs_j, lrs_t, rtol=1e-6,
                                   err_msg="plateau-lr trajectories")
