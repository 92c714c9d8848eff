"""The training step on one device.

Counterpart of ``vipant_tpu/train/step.py:make_train_step``: the loss of the
task model on a batch, its grads with respect to the trainable params only,
``grad_norm`` before clipping, then clip and update. Frozen params carry
``requires_grad=False`` and their towers run under ``torch.no_grad()``, so
no backward is built for them (the JAX step keeps them outside the
differentiated function).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .state import TrainState


def loss_and_grads(state: TrainState, *batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> grad of each trainable param) at the current params;
    nothing is updated."""
    loss = state.model(*batch, train=True)
    names = list(state.trainable)
    grads = torch.autograd.grad(loss, [state.trainable[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(state.trainable[n]) if g is None else g
             for n, g in zip(names, grads)}
    return loss.detach(), grads


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Clip and update from ``grads``; advances ``state.step``. Returns
    ``{"grad_norm", "lr"}``."""
    metrics = state.optimizer.apply(grads)
    state.step += 1
    return metrics


def train_step(state: TrainState, *batch) -> Dict[str, object]:
    """One step: ``{"loss", "grad_norm", "lr"}``, loss and grad_norm as 0-d
    device tensors (reading them syncs the host)."""
    loss, grads = loss_and_grads(state, *batch)
    return {"loss": loss, **apply_gradients(state, grads)}
