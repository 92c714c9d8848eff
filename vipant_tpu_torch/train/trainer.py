"""The VA pre-training trainer on one device, without a data loader yet.

Counterpart of the model, optimizer and step parts of
``vipant_tpu/train/trainer.py:Trainer`` (``build_model`` and
``build_optimizer``): config -> task model with seeded random weights ->
trainable/frozen split (:func:`..models.tunable_mask`) -> optimizer
(:func:`..optim.build_optimizer`) -> :class:`TrainState`, and one training
step on batches the caller provides, as ``bench.py`` drives the JAX step on
device arrays.

``model.image.int8_frozen=True`` runs the frozen image tower on the
forward-only int8 kernels (it runs without autograd, so no gradient ever
reaches them); the trainable towers stay on the bf16 kernels.

Not ported yet, and refused when asked for: the data loaders (the JAX
package's data modules import JAX), the epoch loop with its eval
gates, loading weights and save/resume, the gradient cache, ZeRO and every
mesh axis beyond one device.

Usage::

    from vipant_tpu_torch.train import Trainer
    tr = Trainer([...overrides..., "worker=CVAP"], steps_per_epoch=1000)   # on the card
    images, audios = tr.make_batch(images_np, audios_np)
    metrics = tr.train_step(images, audios)   # {"loss", "grad_norm", "lr"}
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..config import Config

from ..models import build_main_model, init_weights, tunable_mask
from ..optim import build_optimizer, partition_params
from ..utils import as_config, require_device
from .state import TrainState
from .step import train_step


def _refuse_unported(cfg) -> None:
    if str(cfg.get("model_file", "") or ""):
        raise NotImplementedError("loading weights and resuming are not ported yet (model_file)")
    run = cfg.get("running", Config({}))
    gc = run.get("grad_cache", None)
    if gc is not None and bool(gc.get("alive", False)):
        raise NotImplementedError("the gradient cache is not ported yet")
    mesh = cfg.get("mesh", Config({}))
    if bool(mesh.get("zero", False)):
        raise NotImplementedError("ZeRO is not ported yet")
    for axis in ("model", "pipe", "seq"):
        if int(mesh.get(axis, 1)) > 1:
            raise NotImplementedError(f"mesh.{axis} > 1 is not ported yet (one device)")


class Trainer:
    """Builds the model, the trainable/frozen split and the optimizer from
    ``cfg`` on ``device`` (the card by default; raises when there is none);
    :meth:`train_step` runs one step. ``cfg`` is a
    composed config or a list of overrides. ``steps_per_epoch`` sets the
    schedules' epoch length (the JAX trainer takes it from its loader)."""

    def __init__(self, cfg: Union[Config, Sequence[str]], device: Union[str, torch.device] = "cuda",
                 steps_per_epoch: int = 1):
        self.cfg = as_config(cfg)
        _refuse_unported(self.cfg)
        self.device = require_device(device, "Trainer")
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.build_model()
        self.build_optimizer()

    def build_model(self) -> None:
        seed = int(self.cfg.seed)
        self.model = build_main_model(self.cfg, device=self.device)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.trainable, self.frozen = partition_params(self.model, tunable_mask(self.cfg, self.model))

    def build_optimizer(self) -> None:
        opt = build_optimizer(self.cfg.optimizer, self.steps_per_epoch, self.trainable)
        self.state = TrainState(
            step=0, model=self.model, trainable=self.trainable, frozen=self.frozen,
            optimizer=opt, generator=torch.Generator(device=self.device).manual_seed(int(self.cfg.seed)),
        )

    def make_batch(self, *arrays: np.ndarray):
        """Host arrays -> fp32 tensors on the device (integer arrays keep
        their dtype: token ids)."""
        out = []
        for a in arrays:
            t = torch.as_tensor(np.ascontiguousarray(a))
            out.append(t.to(self.device, torch.float32 if t.is_floating_point() else t.dtype))
        return tuple(out)

    def train_step(self, *batch: torch.Tensor) -> Dict[str, object]:
        return train_step(self.state, *batch)

    def learn(self):
        raise NotImplementedError(
            "the epoch loop needs the data loader, which is not ported yet: "
            "drive train_step on device batches")
