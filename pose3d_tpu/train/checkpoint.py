"""Checkpoint save/restore as one flat ``.npz``, reference-compatible layout.

Replaces ``torch.save({'epoch','batch_size','model','optimizer'},
"./logs/models/"+run_name)`` (train_1.py:186, train_3.py:168, train_5.py:336)
with a checkpoint of the train-state pytree {step, params, batch_stats,
opt_state, plateau} plus run metadata. Each leaf is stored under its tree
path (``params/Dense_0/kernel``, ``opt_state/0/mu/...``), so a checkpoint can
be read back into a live state, or its params alone without knowing the
architecture. The ``logs/models/<run_name>`` path convention is preserved so
the cross-phase checkpoint-reuse workflow (phase5 loading the phase1 lifter,
train_5.py:64-69) looks the same.

Failure recovery (SURVEY.md section 5): ``save`` is atomic (the file is
written beside its target, then renamed), and the trainers install a
KeyboardInterrupt handler that snapshots an ``interrupt_<run>`` checkpoint —
the reference's CtlCSave behavior (train_3.py:252-256).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

_FILE = "state.npz"
_DTYPES = "__dtypes__"


def _ckpt_dir(log_dir, run_name: str) -> pathlib.Path:
    return (pathlib.Path(log_dir) / "models" / run_name).absolute()


def _payload(state) -> dict:
    return {
        "step": state.step,
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
        "plateau": dataclasses.asdict(state.plateau),
    }


def _flat(tree) -> dict:
    """Tree -> {"a/b/c": leaf}; dict keys, sequence indices and attribute
    names joined by "/"."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path, simple=True, separator="/"): leaf
            for path, leaf in leaves}


def save(state, log_dir, run_name: str, *, batch_size: int | None = None,
         extra: dict | None = None) -> str:
    """Checkpoint a TrainState atomically; run metadata goes to a
    ``.meta.json`` sidecar."""
    path = _ckpt_dir(log_dir, run_name)
    path.mkdir(parents=True, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in _flat(_payload(state)).items()}
    # numpy has no bfloat16: such leaves are stored as raw bits beside
    # their dtype name
    dtypes = {k: str(a.dtype) for k, a in arrays.items()}
    tmp = path / (_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays, **{_DTYPES: np.asarray(json.dumps(dtypes))})
    os.replace(tmp, path / _FILE)
    meta = {"batch_size": batch_size or 0, **(extra or {})}
    with open(str(path) + ".meta.json", "w") as f:
        json.dump(meta, f)
    return str(path)


def _load(log_dir, run_name: str, prefix: str = "") -> dict:
    """{"a/b/c": np.ndarray} of the stored leaves whose path starts with
    ``prefix``."""
    with np.load(_ckpt_dir(log_dir, run_name) / _FILE) as z:
        dtypes = json.loads(str(z[_DTYPES]))
        return {k: z[k].view(jnp.dtype(dtypes[k])) for k in z.files
                if k != _DTYPES and k.startswith(prefix)}


def _fill(template, stored: dict, prefix: str):
    """Template tree with each leaf replaced by its stored value. A leaf
    that is a mesh-sharded jax.Array comes back on the same sharding, so
    the resumed state keeps the TP/DP layout it was saved under;
    everything else comes back as host numpy."""
    flat = _flat(template)
    missing = [k for k in flat if prefix + k not in stored]
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]}")

    def leaf(path, x):
        value = stored[prefix + jax.tree_util.keystr(
            path, simple=True, separator="/")]
        if value.shape != np.shape(x):
            raise ValueError(f"{jax.tree_util.keystr(path)}: checkpoint "
                             f"shape {value.shape} != {np.shape(x)}")
        if isinstance(x, jax.Array) and isinstance(
                x.sharding, jax.sharding.NamedSharding):
            return jax.device_put(value, x.sharding)
        return value

    return jax.tree_util.tree_map_with_path(leaf, template)


def restore(state, log_dir, run_name: str):
    """Restore into the shape (and sharding) of an existing TrainState.
    Returns (state, meta dict)."""
    from pose3d_tpu.train.schedule import PlateauState

    payload = _fill(_payload(state), _load(log_dir, run_name), "")
    state = state.replace(
        step=payload["step"],
        params=payload["params"],
        batch_stats=payload["batch_stats"],
        opt_state=payload["opt_state"],
        plateau=PlateauState(**payload["plateau"]),
    )
    return state, load_meta(log_dir, run_name)


def peek_params(log_dir, run_name: str):
    """Load ONLY the ``params`` subtree of a checkpoint whose architecture
    is unknown: the nested dict is rebuilt from the stored paths, so
    inference tooling (cli.predict) adapts to whatever architecture the
    checkpoint was trained with, without reading the optimizer state."""
    params: dict = {}
    for key, value in _load(log_dir, run_name, "params/").items():
        *parents, name = key.split("/")[1:]
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value
    return params


def restore_params(log_dir, run_name: str, params_template,
                   batch_stats_template=None):
    """Load only model params (+ batch stats): cross-model checkpoint reuse
    (the phase5 pattern of loading a frozen phase1 lifter, train_5.py:64-69)
    and inference-time restore that must not depend on the optimizer layout.
    Returns params (or (params, batch_stats) when a stats template is given).
    """
    stored = _load(log_dir, run_name)
    params = _fill(params_template, stored, "params/")
    if batch_stats_template is None:
        return params
    return params, _fill(batch_stats_template, stored, "batch_stats/")


def load_meta(log_dir, run_name: str) -> dict:
    """Read the .meta.json sidecar ({} when absent) — run metadata that
    array trees can't carry (batch_size, and non-shape-derivable
    architecture fields like the temporal lifter's head count)."""
    meta_path = str(_ckpt_dir(log_dir, run_name)) + ".meta.json"
    if not pathlib.Path(meta_path).exists():
        return {}
    with open(meta_path) as f:
        return json.load(f)


def exists(log_dir, run_name: str) -> bool:
    return _ckpt_dir(log_dir, run_name).exists()
