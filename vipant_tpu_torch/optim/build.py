"""Optimizer assembly from config: global-norm clipping, then LARS or Adam.

Counterpart of ``vipant_tpu/optim/build.py``. The LARS path scales its base
rate by ``batch_size / 256`` and warms up over ``warmup_epoch`` epochs even
when ``optimizer.warmup`` is false, as the JAX package does. The Adam path
is optax's ``scale_by_adam -> add_decayed_weights -> -lr(step)``: decoupled,
lr-scaled weight decay, which is ``torch.optim.AdamW`` with the rate set
per step (``torch.optim.Adam(weight_decay=...)`` is another optimizer).

Clipping is optax's ``clip_by_global_norm``: grads are scaled by
``max_norm / norm`` only when ``norm >= max_norm`` (no epsilon, unlike
``torch.nn.utils.clip_grad_norm_``), over the trainable grads only.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from .lars import LARS, Schedule, warmup_cosine_lr, warmup_multistep_lr


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """optax's rule: ``g / norm * max_norm`` if ``norm >= max_norm``, else
    ``g``. Returns new tensors; no host sync."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Optimizer:
    """The update of one training step over the named trainable params:
    clip (if ``max_norm``), set the rate from ``schedule`` at the update
    count, then step ``inner`` (:class:`LARS` or ``torch.optim.AdamW``)."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], inner: torch.optim.Optimizer,
                 schedule: Schedule, max_norm: Optional[float] = None):
        self.params = dict(params)
        self.inner, self.schedule, self.max_norm = inner, schedule, max_norm
        self.count = 0

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, object]:
        """One update from ``grads`` (name -> grad of every trainable
        param). Returns ``{"grad_norm": norm before clipping (0-d tensor),
        "lr": this update's rate}``."""
        names = list(self.params)
        gs = [grads[n] for n in names]
        norm = global_norm(gs)
        if self.max_norm:
            gs = clip_by_global_norm(gs, float(self.max_norm), norm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self._update(dict(zip(names, gs)))
        self.count += 1
        return {"grad_norm": norm, "lr": lr}

    def _update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """Step ``inner`` on the (clipped) grads."""
        for n, g in grads.items():
            self.params[n].grad = g
        self.inner.step()
        for p in self.params.values():
            p.grad = None

    def state_bytes(self) -> int:
        """Bytes of the optimizer state this process holds."""
        return sum(v.numel() * v.element_size() for st in self.inner.state.values()
                   for v in st.values() if torch.is_tensor(v))

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: Mapping) -> None:
        self.count = int(sd["count"])
        self.inner.load_state_dict(sd["inner"])


def inner_factory(opt_cfg) -> Callable[[Mapping[str, torch.nn.Parameter]], torch.optim.Optimizer]:
    """``optimizer`` config -> the builder of the inner optimizer (:class:`LARS`
    or ``torch.optim.AdamW``) over named params."""
    if bool(opt_cfg.get("use_lars", False)):
        kw = dict(lr_weight=float(opt_cfg.get("lr_weight", 0.2)),
                  lr_bias=float(opt_cfg.get("lr_bias", 0.0048)), eta=float(opt_cfg.get("eta", 0.001)),
                  weight_decay=float(opt_cfg.get("weight_decay", 1e-6)))
        return lambda named: LARS(named.items(), **kw)
    betas = opt_cfg.get("betas", [0.9, 0.999])
    kw = dict(lr=float(opt_cfg.lr), betas=(float(betas[0]), float(betas[1])), eps=1e-8,
              weight_decay=float(opt_cfg.get("weight_decay", 0.0)))
    return lambda named: torch.optim.AdamW(list(named.values()), **kw)


def build_optimizer(opt_cfg, steps_per_epoch: int,
                    params: Mapping[str, torch.nn.Parameter], zero_mesh=None) -> Optimizer:
    """``optimizer`` config -> :class:`Optimizer` over ``params`` (the
    trainable ones, by name). ``zero_mesh``: a data mesh of more than one
    rank over which the optimizer state is split (ZeRO-1,
    :class:`..parallel.zero.ZeroOptimizer`)."""
    epochs = int(opt_cfg.epochs)
    total_steps = max(epochs * steps_per_epoch, 1)
    if bool(opt_cfg.get("use_lars", False)):
        base_lr = float(opt_cfg.batch_size) / 256.0
        warmup_steps = int(opt_cfg.get("warmup_epoch", 10)) * steps_per_epoch
        schedule = warmup_cosine_lr(base_lr, total_steps, warmup_steps)
    else:
        lr = float(opt_cfg.lr)
        warmup_steps = int(opt_cfg.get("warmup_steps", 0)) if opt_cfg.get("warmup", False) else 0
        milestones = tuple(int(m) * steps_per_epoch for m in (opt_cfg.get("steps", []) or []))
        schedule = warmup_multistep_lr(lr, max(warmup_steps, 1), milestones,
                                       float(opt_cfg.get("gamma", 0.5)))
    max_norm = opt_cfg.get("max_norm", None)
    max_norm = float(max_norm) if max_norm else None
    make_inner = inner_factory(opt_cfg)
    if zero_mesh is not None and zero_mesh.parallel:
        from ..parallel.zero import ZeroOptimizer

        return ZeroOptimizer(params, make_inner, schedule, max_norm, zero_mesh)
    return Optimizer(params, make_inner(dict(params)), schedule, max_norm)
