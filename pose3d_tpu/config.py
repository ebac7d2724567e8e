"""Typed config tree replacing the reference's three informal mechanisms
(module-level globals, __main__ literals, vestigial argparse — SURVEY.md
section 5 "Config / flag system"). Every behavior flag of the reference has a
field here; per-phase presets mirror the reference's committed defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class DataConfig:
    """H36_dataset.py:10-50 config globals."""

    data_dir: Optional[str] = None   # H36M root (npz/ under it); None => synthetic
    action: str = ""                 # substring filter, e.g. "Posing"/"Walking"
    zero_centre: bool = True
    standardize_2d: bool = False
    standardize_3d: bool = False
    normalize: bool = False
    num_joints: int = 17
    split_rate: Optional[int] = None
    mono_3d_file: bool = True
    camera_view: bool = True
    all_cameras: bool = False
    synthetic_frames: int = 16384    # synthetic fallback size (train)
    train_subjects: tuple = ("S1", "S5", "S6", "S7", "S8")
    test_subjects: tuple = ("S9", "S11")


@dataclasses.dataclass
class LiftConfig:
    """Phase-1 trainer config (train_1.py:191-203 __main__ literals)."""

    model: str = "vit"               # vit | martinez | ae (train_1.py:34-35)
    batch_size: int = 64
    n_epochs: int = 150
    lr: float = 1e-4
    run_name: str = "lift_run"
    resume: bool = False
    flip: bool = False               # validation flip-TTA (Flip flag)
    loss: str = "mse"                # MSELoss (train_1.py:37); l1 available
    grad_clip: float = 0.0           # global-norm clip (legacy main.py:467)
    log_dir: str = "./logs"
    seed: int = 0
    ctlc_save: bool = True           # interrupt checkpoint (train_3.py:252-256)
    data: DataConfig = dataclasses.field(
        default_factory=lambda: DataConfig(action="Posing")
    )


@dataclasses.dataclass
class DirectConfig:
    """Phase-3/4 trainer config (train_3.py:234-262, phase4 train.py)."""

    architecture: str = "resnet50"
    batch_size: int = 64
    n_epochs: int = 20
    lr: float = 1e-3
    run_name: str = "direct_run"
    resume: bool = False
    z_scale: float = 2.5             # 2.5 phase3 / 2.0 phase4
    image_size: int = 256            # reference input geometry (H36_dataset.py:129)
    source: str = "h36m"             # h36m (phase3) | video (phase4)
    video: str = ""                  # phase4: video name under pipeline_root
    pipeline_root: str = "./videos"  # phase4: phase-2 artifact root
    heatmap_loss_weight: float = 0.0 # optional heatmap MSE supervision
    chunk_steps: int = 8             # optimizer steps per dispatch (lax.scan)
    loss: str = "mse"                # MSE + Adam wd 1e-8 (train_3.py:30)
    # None resolves per source to the reference phase's optimizer ctor:
    # h36m -> Adam(weight_decay=1e-8) (train_3.py:31); video -> bare
    # Adam(lr) i.e. no decay (phase4_joined/train.py:39)
    weight_decay: Optional[float] = None
    optimizer: str = "adam"
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True
    data: DataConfig = dataclasses.field(
        default_factory=lambda: DataConfig(action="1.6", split_rate=50)
    )


@dataclasses.dataclass
class DetectorConfig:
    """2D-detector trainer config (cli/train_detector.py): PoseNet2D
    distilled on device-rendered skeleton frames so the video pipeline's
    --detector posenet2d route has trained weights (the reference's
    equivalent capability is the external openpifpaf checkpoint,
    phase2_opp_mb/run.py:134-166)."""

    architecture: str = "resnet18"
    batch_size: int = 32
    n_steps: int = 600
    lr: float = 1e-3
    run_name: str = "detector2d"
    resume: bool = False
    image_size: int = 256
    n_train: int = 4096              # synthetic pose pool size
    n_eval: int = 256
    chunk_steps: int = 8             # optimizer steps per dispatch (lax.scan)
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True


@dataclasses.dataclass
class LoopConfig:
    """Phase-5 consistency-loop config (train_5.py:342-374)."""

    triangle: bool = False
    triangle_mode: str = "sep"       # sep (TriangleLoss_sep) | cycle (TriangleLoss)
    flip: bool = False
    project: bool = False
    batch_size: int = 64
    n_epochs: int = 20
    lr: float = 5e-4                 # AdamW lr 5e-4 (train_5.py:79-80)
    run_name: str = "loop_run"
    lifter_checkpoint: Optional[str] = None    # frozen phase1 lifter run name
    projector_checkpoint: Optional[str] = None # frozen projector run name
    resume: bool = False
    log_dir: str = "./logs"
    seed: int = 0
    bf16: bool = True
    architecture: str = "resnet50"
    image_size: int = 256
    data: DataConfig = dataclasses.field(
        default_factory=lambda: DataConfig(action="Walking", split_rate=64)
    )


@dataclasses.dataclass
class TemporalConfig:
    """Temporal (MotionBERT-style) sequence lifter config (BASELINE config #3)."""

    clip_len: int = 243
    hidden: int = 256
    n_blocks: int = 5
    heads: int = 8
    batch_size: int = 16
    n_epochs: int = 30
    lr: float = 5e-4
    # compute in bfloat16 (params and optimizer stay float32), as
    # DirectConfig.bf16
    bf16: bool = True
    run_name: str = "temporal_run"
    resume: bool = False
    loss: str = "mse"
    log_dir: str = "./logs"
    seed: int = 0
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def _add_fields(parser: argparse.ArgumentParser, cls, prefix=""):
    # All argparse defaults are None: a flag the user did not pass must NOT
    # override the per-phase preset (e.g. LiftConfig's action="Posing").
    for f in dataclasses.fields(cls):
        if dataclasses.is_dataclass(f.type) or f.name == "data":
            _add_fields(parser, DataConfig, prefix=f"{f.name}.")
            continue
        name = f"--{prefix}{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif f.type in ("int", int, "Optional[int]"):
            parser.add_argument(name, type=int, default=None)
        elif f.type in ("float", float, "Optional[float]"):
            parser.add_argument(name, type=float, default=None)
        elif f.type == "tuple" or f.type is tuple:
            parser.add_argument(name, type=lambda s: tuple(s.split(",")),
                                default=None)
        else:
            parser.add_argument(name, type=str, default=None)


def parse_config(cls, argv=None):
    """Build a config dataclass from CLI flags (--field value, --data.field).
    ``JAX_PLATFORMS=cpu`` in the environment runs any CLI on the CPU."""
    parser = argparse.ArgumentParser()
    _add_fields(parser, cls)
    args = vars(parser.parse_args(argv))
    data_kwargs = {k.split(".", 1)[1]: v for k, v in args.items()
                   if k.startswith("data.") and v is not None}
    main_kwargs = {k: v for k, v in args.items()
                   if "." not in k and v is not None}
    cfg = cls(**main_kwargs)
    if data_kwargs:
        cfg.data = dataclasses.replace(cfg.data, **data_kwargs)
    return cfg
