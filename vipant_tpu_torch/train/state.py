"""Train state: step, trainable and frozen params, optimizer state, rng.

Counterpart of ``vipant_tpu/train/state.py``. The JAX state is an
immutable pytree that each step returns anew; here the model's parameters
and the optimizer's buffers are updated in place and the state holds
references to them. ``state_dict()`` gathers everything a resume needs, for
``torch.save``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

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

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "params": {k: p.detach() for k, p in self.trainable.items()},
            "frozen_params": {k: p.detach() for k, p in self.frozen.items()},
            "opt_state": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
        }
