"""Trainable/frozen parameter split.

Counterpart of ``vipant_tpu/optim/partition.py``. The JAX package keeps the
frozen params outside the differentiated function, so XLA builds no
backward for them and the optimizer holds no state for them. Here a frozen
parameter gets ``requires_grad_(False)`` (autograd records nothing for a
tower whose params all have it, and the task models run such a tower under
``torch.no_grad()``), and only the trainable ones go to the optimizer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from torch import nn

Params = Dict[str, nn.Parameter]


def partition_params(model: nn.Module, mask: Mapping[str, bool]) -> Tuple[Params, Params]:
    """(trainable, frozen), each name -> parameter, by ``mask`` (True =
    trainable, every parameter named). Sets ``requires_grad`` to match."""
    named = dict(model.named_parameters())
    if set(named) != set(mask):
        raise ValueError(f"mask and model disagree on {sorted(set(named) ^ set(mask))}")
    trainable, frozen = {}, {}
    for name, p in named.items():
        p.requires_grad_(bool(mask[name]))
        (trainable if mask[name] else frozen)[name] = p
    return trainable, frozen
