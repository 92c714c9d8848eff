"""Train state: step, trainable and frozen params, optimizer state, rng.

Counterpart of ``vipant_tpu/train/state.py``. The JAX state is an
immutable pytree that each step returns anew; here the model's parameters
and the optimizer's buffers are updated in place and the state holds
references to them. ``buffers`` are the model's running statistics (the JAX
``batch_stats`` collection: Barlow's BatchNorm), which a training forward
updates in place. ``state_dict()`` gathers everything a resume needs, for
``torch.save`` (under ZeRO every rank takes part and rank 0 gets the full
optimizer state). ``mesh`` is the data mesh (:mod:`..parallel.mesh`) whose
ranks average the grads; None on one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..optim.build import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    trainable: Dict[str, nn.Parameter]
    frozen: Dict[str, nn.Parameter]
    optimizer: Optimizer
    generator: torch.Generator
    # keyword arguments of the model's loss call beside ``train=True``
    # (CLAP with a decoder: ``retrieval``)
    loss_kwargs: Dict[str, Any] = field(default_factory=dict)
    buffers: Dict[str, torch.Tensor] = field(default_factory=dict)
    mesh: Optional[Any] = None

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "params": {k: p.detach() for k, p in self.trainable.items()},
            "frozen_params": {k: p.detach() for k, p in self.frozen.items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
            "buffers": {k: b.detach() for k, b in self.buffers.items()},
        }
