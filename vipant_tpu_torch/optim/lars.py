"""LARS and the learning-rate schedules.

Counterpart of ``vipant_tpu/optim/lars.py``, which is the reference even
where it looks odd: the cosine schedule clamps past ``total_steps``, the
multistep warmup reads ``step + 1``, and LARS puts every parameter with
``ndim > 1`` whose name does not end in ``bias`` in its weight group (trust
ratio, weight decay, ``lr * lr_weight``) and everything else -- LayerNorm
weights, ``class_embedding``, ``in_proj_bias``, ``logit_scale`` -- in the
bias/gain group (``lr * lr_bias``, no decay, no adaptation). Norms do not
depend on layout, so torch's [3C, C] qkv weight gets the trust ratio of
the JAX package's [C, 3, C] one.

Schedules are plain functions of the update count (a Python int) that
return a Python float.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def warmup_cosine_lr(base_lr: float, total_steps: int, warmup_steps: int,
                     end_lr_ratio: float = 0.001) -> Schedule:
    """Linear warmup to ``base_lr``, then cosine to ``base_lr * end_lr_ratio``,
    held there past ``total_steps``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        t = max(total_steps - warmup_steps, 1)
        s = min(max(step - warmup_steps, 0), t)
        q = 0.5 * (1.0 + math.cos(math.pi * s / t))
        return base_lr * q + base_lr * end_lr_ratio * (1.0 - q)

    return schedule


def warmup_multistep_lr(base_lr: float, warmup_steps: int, milestones_steps: Sequence[int] = (),
                        gamma: float = 0.5) -> Schedule:
    """Linear warmup (reaching ``base_lr`` at ``step + 1 == warmup_steps``),
    then ``base_lr * gamma ** (milestones passed)``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return min(base_lr * (step + 1) / max(warmup_steps, 1), base_lr)
        return base_lr * gamma ** sum(step >= m for m in milestones_steps)

    return schedule


def is_lars_weight(name: str, p: torch.Tensor) -> bool:
    """LARS's weight group: ``ndim > 1`` and not a bias."""
    return p.dim() > 1 and not name.endswith("bias")


class LARS(torch.optim.Optimizer):
    """LARS with heavyweight momentum over named parameters, reading
    ``p.grad``. Each group's ``lr`` is set by the caller before each step
    (:class:`vipant_tpu_torch.optim.build.Optimizer` sets it from the
    schedule at the update count). For a weight ``p``::

        d = g + weight_decay * p
        q = eta * |p| / |d|   (1 if either norm is 0)
        v = momentum * v + lr * lr_weight * q * d;   p -= v

    and for a bias or gain ``v = momentum * v + lr * lr_bias * g``. A
    parameter without a grad is updated as if its grad were zero. Each
    parameter's trust ratio is its own, as the JAX LARS takes one per layer
    of a stacked trunk. ``reduce(p, sq)`` turns a sum of squares of this
    rank's ``p`` into the full leaf's (a leaf split over the model axis);
    by default the sum is the leaf's."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr_weight: float = 0.2, lr_bias: float = 0.0048, momentum: float = 0.9,
                 eta: float = 0.001, weight_decay: float = 1e-6, reduce=None):
        named = list(named_params)
        self.reduce = reduce
        groups = [
            {"params": [p for n, p in named if is_lars_weight(n, p)], "weight": True},
            {"params": [p for n, p in named if not is_lars_weight(n, p)], "weight": False},
        ]
        defaults = dict(lr=0.0, lr_weight=lr_weight, lr_bias=lr_bias, momentum=momentum, eta=eta,
                        weight_decay=weight_decay)
        super().__init__([g for g in groups if g["params"]], defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, m = group["lr"], group["momentum"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if "momentum" not in state:
                    state["momentum"] = torch.zeros_like(p)
                v = state["momentum"]
                if group["weight"]:
                    d = g + group["weight_decay"] * p
                    if self.reduce is None:
                        pn, dn = torch.linalg.vector_norm(p), torch.linalg.vector_norm(d)
                    else:
                        pn = torch.sqrt(self.reduce(p, torch.sum(torch.square(p))))
                        dn = torch.sqrt(self.reduce(p, torch.sum(torch.square(d))))
                    q = torch.where((pn > 0) & (dn > 0),
                                    group["eta"] * pn / torch.clamp(dn, min=1e-12),
                                    torch.ones_like(pn))
                    v.mul_(m).add_(lr * group["lr_weight"] * q * d)
                else:
                    v.mul_(m).add_(lr * group["lr_bias"] * g)
                p.sub_(v)
