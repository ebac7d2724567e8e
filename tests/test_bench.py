"""bench.py and the shared runtime helpers on the CPU: the peak table, the
timing and FLOP plumbing, the compile-cache rule, and the refusal to
measure anywhere but on a GPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from pose3d_tpu.utils import runtime


class TestPeaks:
    def test_h100_from_the_data_sheet(self):
        p = bench.peaks_for("NVIDIA H100 80GB HBM3")
        assert p["bf16_flops"] == 989e12
        assert p["hbm_bytes_s"] == 3.35e12
        assert "data sheet" in p["source"]

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100",
                                      ""])
    def test_unknown_device_is_an_error(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.peaks_for(kind)


class TestCompileCacheRule:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv(runtime.ENV_CACHE, str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_under_the_repo(self, monkeypatch, tmp_path):
        monkeypatch.delenv(runtime.ENV_CACHE, raising=False)
        monkeypatch.chdir(tmp_path)  # not relative to the working dir
        want = os.path.join(runtime.REPO_ROOT, "logs", "jax_cache")
        assert runtime.compile_cache_dir() == want
        before = jax.config.jax_compilation_cache_dir
        try:
            assert runtime.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_empty_env_var_means_unset(self, monkeypatch):
        monkeypatch.setenv(runtime.ENV_CACHE, "")
        assert runtime.compile_cache_dir().endswith(
            os.path.join("logs", "jax_cache"))


class TestTimingPlumbing:
    def test_measure_excludes_compile_and_reports_spread(self):
        f = jax.jit(lambda x: x @ x)
        x = jnp.ones((64, 64))
        calls = []

        def call():
            calls.append(1)
            return f(x)

        t = bench.measure(call, iters=3, repeats=2)
        assert len(calls) == 1 + 3 * 2
        lo, hi = t["ms_min_max"]
        assert 0 < lo <= t["ms"] <= hi
        assert t["compile_s"] >= 0

    def test_block_flops_by_hand(self):
        # d=1, ratio 4: 2*(3+1+8) matmul FLOPs + 4*seq attention per token
        assert bench.block_flops(tokens=1, seq=1, dim=1) == 28.0
        assert bench.block_flops(tokens=3, seq=5, dim=2) == 3 * (
            2 * 12 * 4 + 4 * 5 * 2)


def _kernel_flops(params, tokens):
    """2*tokens*k*n over every dense kernel of a param tree."""
    return sum(2.0 * tokens * k.shape[0] * k.shape[1]
               for path, k in jax.tree_util.tree_leaves_with_path(params)
               if getattr(path[-1], "key", "") == "kernel")


@pytest.mark.parametrize("frames", [1, 8192])
def test_lifter_flops_match_the_model_shapes(frames):
    from pose3d_tpu.models.lifters import JointTransformerLifter

    m = JointTransformerLifter()
    p = jax.eval_shape(lambda: m.init(jax.random.key(0),
                                      jnp.zeros((1, 17, 2))))["params"]
    attention = m.n_blocks * frames * 17 * 4.0 * 17 * m.hidden
    assert bench.lifter_flops(frames) == pytest.approx(
        _kernel_flops(p, frames * 17) + attention)


@pytest.mark.parametrize("clips", [1, 8])
def test_temporal_flops_match_the_model_shapes(clips):
    from pose3d_tpu.models.temporal import TemporalLifter

    m = TemporalLifter()
    p = jax.eval_shape(lambda: m.init(jax.random.key(0),
                                      jnp.zeros((1, 243, 17, 2))))["params"]
    tokens = clips * 243 * 17
    attention = m.n_blocks * tokens * 4.0 * (17 + 243) * m.hidden
    fwd = _kernel_flops(p, tokens) + attention
    assert bench.temporal_flops(clips) == pytest.approx(fwd)
    assert bench.temporal_flops(clips, train=True) == pytest.approx(3 * fwd)


class TestRates:
    def test_rate_fields(self):
        r = bench.rate_fields(1000, {"ms": 2.0, "ms_min_max": [1.9, 2.2],
                                     "compile_s": 1.0}, 4e9, 1e12)
        assert r["items_per_s"] == pytest.approx(5e5)
        assert r["tflops"] == pytest.approx(2.0)
        assert r["share_of_bf16_peak"] == pytest.approx(2.0)
        assert "tflops" not in bench.rate_fields(
            1, {"ms": 1.0, "ms_min_max": [1, 1], "compile_s": 0}, None, 1.0)


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit, match="not a GPU"):
        bench.main()
    assert capsys.readouterr().out == ""  # no result line


def test_cells_cover_the_roadmap_workloads():
    assert [n for n, _ in bench.CELLS] == [
        "lifting_infer", "flip_lift", "direct_train", "temporal_train",
        "temporal_infer", "e2e_video"]


def test_torch_reference_matches_the_lifter_shape():
    pytest.importorskip("torch")
    assert np.isfinite(bench.torch_cpu_lifting_rate())
