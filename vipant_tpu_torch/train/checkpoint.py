"""Checkpoints of the port's trainer: the whole train state with
``torch.save``, a config snapshot and a weight export the JAX package reads.

Counterpart of ``vipant_tpu/ckpt/orbax_io.py:68-160,327-377``. A save writes
``{ckpt_dir}/{step:08d}/`` with

- ``state.pt``: :meth:`TrainState.state_dict` (trainable and frozen params,
  the optimizer's buffers and update count, which is the schedule's
  position, the step, the RNG state and the model's running statistics);
- ``config.json``: the config, unresolved;
- ``model.npz`` (optional): a weight export under the JAX package's flat
  dotted names and layouts (:func:`..ckpt.from_jax.to_jax_params`), which
  both packages' ``InferenceEngine(model_file=<step dir>)`` serve, and
  ``batch_stats.npz`` beside it when the model has running statistics (the
  JAX ``batch_stats`` collection under its flat dotted names; the JAX
  engine refuses a ``model.npz`` key that is no parameter);
- ``{step:08d}.pth`` (with ``export_pth``): the same export as a
  reference-format checkpoint (:func:`..ckpt.reference_export.export_reference_pth`),
  which the reference, both packages' engines and trainers
  (``model_file=<it>``) read;
- ``COMMITTED``, written last: a step directory without it is a save that
  did not finish, never loaded and pruned at the next save.

:func:`load_checkpoint` restores every tensor bitwise, the step and the RNG.
:func:`extract_model_files` reads the step directories a training log names.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..ckpt.from_jax import flatten, to_jax_batch_stats, to_jax_params
from ..ckpt.reference_export import export_reference_pth, split_by_tower
from .state import TrainState

COMMIT_MARKER = "COMMITTED"
_STEP_DIR = re.compile(r"\d{8}")


def is_committed(step_dir: str) -> bool:
    return os.path.exists(os.path.join(step_dir, COMMIT_MARKER))


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState, cfg=None,
                    model_only: Optional[Mapping[str, torch.Tensor]] = None,
                    keep_last: int = 0, export_pth: bool = False) -> str:
    """Write ``{ckpt_dir}/{step:08d}/`` (see the module docstring) and
    return its path. ``model_only``: the port's name -> tensor of the
    params to export as ``model.npz`` (and with ``export_pth`` as
    ``{step:08d}.pth``). ``keep_last`` > 0 keeps the newest N committed
    step directories (never the one just written) and removes uncommitted
    ones."""
    root = os.path.abspath(ckpt_dir)
    name = f"{step:08d}"
    path = os.path.join(root, name)
    if os.path.exists(path):  # re-saving a step (a resumed run) overwrites
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(state.state_dict(), os.path.join(path, "state.pt"))
    if cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg.to_dict(resolve=False), f)
    if model_only is not None:
        np.savez(os.path.join(path, "model.npz"), **flatten(to_jax_params(model_only)))
        if state.buffers:
            np.savez(os.path.join(path, "batch_stats.npz"),
                     **flatten(to_jax_batch_stats(state.buffers)))
        if export_pth:
            export_reference_pth(os.path.join(path, f"{name}.pth"), split_by_tower(model_only), cfg=cfg)
    with open(os.path.join(path, COMMIT_MARKER), "w") as f:
        f.write(f"{step}\n")
    if keep_last > 0:
        others = [d for d in os.listdir(root) if _STEP_DIR.fullmatch(d) and d != name]
        done = [d for d in others if is_committed(os.path.join(root, d))]
        # crash leftovers, then the oldest committed ones by step; a resumed
        # run may write a lower step than stale later ones and keeps it
        oldest = [d for d in sorted(done + [name])[:-keep_last] if d != name]
        for d in [d for d in others if d not in done] + oldest:
            shutil.rmtree(os.path.join(root, d))
    return path


def _restore(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: the checkpoint and the model disagree on "
                       f"{sorted(set(dst) ^ set(src))}")
    with torch.no_grad():
        for k, t in dst.items():
            if tuple(t.shape) != tuple(src[k].shape) or t.dtype != src[k].dtype:
                raise ValueError(f"{what} {k}: model {tuple(t.shape)} {t.dtype}, checkpoint "
                                 f"{tuple(src[k].shape)} {src[k].dtype}")
            t.copy_(src[k])


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from a step directory written by
    :func:`save_checkpoint`: params, running statistics, optimizer, step and
    RNG, bitwise. The
    names must be the model's exactly (a name matches whole, never as a
    part of another)."""
    if not is_committed(path):
        raise FileNotFoundError(f"{path} holds no committed checkpoint (no {COMMIT_MARKER})")
    sd: Dict[str, Any] = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                                    weights_only=True)
    _restore(state.trainable, sd["params"], "trainable param")
    _restore(state.frozen, sd["frozen_params"], "frozen param")
    _restore(state.buffers, sd.get("buffers", {}), "running statistic")
    state.optimizer.load_state_dict(sd["opt_state"])
    state.generator.set_state(sd["rng"])
    state.step = int(sd["step"])
    return state


def extract_model_files(log_path: str) -> List[str]:
    """The step directories a training log names, in its order: the lines
    ``saving the checkpoint to <path>`` that :meth:`..trainer.Trainer.save`
    logs (the reference's repeated eval reads the log as a manifest,
    `reference/cvap/model/helper.py:65-77`)."""
    pat = re.compile(r"saving the checkpoint to (\S+)")
    with open(log_path) as f:
        return [m.group(1) for m in map(pat.search, f) if m]
