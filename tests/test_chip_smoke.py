"""chip_smoke.py rehearsed on the CPU at small widths: phase selection,
the result line, the refusal to run without a GPU, and every phase's
mechanics (the widths and the timings belong to the card)."""

import json
import sys

import jax
import pytest

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
import chip_smoke  # noqa: E402

SMALL = {
    "serve_requests": (1, 5, 64, 100),
    "serve_max_batch": 64,
    "lifter": {"hidden": 32, "n_blocks": 1, "heads": 2},
    "temporal": {"clip_len": 16, "hidden": 32, "n_blocks": 1, "heads": 2},
    "temporal_batch": 8,
    "temporal_epochs": 3,
    "serve_frames": 40,
    "direct": {"architecture": "resnet18", "depth": 8},
    "direct_batch": 4,
    "image": 32,
    "direct_steps": 2,
}


def test_result_line_format():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": "dropped"})
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("chips,expected", [
    (1, ("serve", "temporal_train", "temporal_serve", "direct_train")),
    (4, ("dp_temporal_train", "dp_direct_train")),
])
def test_phase_selection(chips, expected, monkeypatch):
    assert chip_smoke.phases(chips) == expected
    monkeypatch.setattr(chip_smoke, "has_flax", lambda: False)
    assert chip_smoke.phases(chips) == tuple(
        n for n in expected if "direct" not in n)


def test_refuses_to_run_without_a_gpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="not a GPU"):
        chip_smoke.phase_device(1)


def test_full_width_is_the_flagship():
    full = chip_smoke.FULL
    assert full["temporal"] == {"clip_len": 243, "hidden": 256,
                                "n_blocks": 5, "heads": 8}
    assert full["serve_max_batch"] == 8192 and full["lifter"] == {}
    assert full["direct_batch"] == 64 and full["image"] == 256


@pytest.mark.parametrize("name", chip_smoke.ONE_CARD)
def test_one_card_phase_small(name):
    getattr(chip_smoke, f"phase_{name}")(SMALL)


@pytest.mark.parametrize("name", chip_smoke.FOUR_CARDS)
def test_four_card_phase_small(name, devices):
    """--chips 4 rehearsed on 4 of the virtual CPU devices."""
    getattr(chip_smoke, f"phase_{name}")(SMALL, devices[:4])


def test_run_four_cards_reports_count(devices, monkeypatch):
    ran = []
    for name in chip_smoke.FOUR_CARDS:
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda size, devs, n=name: ran.append(
                                (n, len(devs))))
    info = chip_smoke.run(4, SMALL)
    assert info["count"] == 4
    assert ran == [(n, 4) for n in chip_smoke.FOUR_CARDS]
