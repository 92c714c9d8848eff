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

Over a mesh whose ``model`` or ``pipe`` axis splits the parameters
(``split``: name -> the axis, :class:`..parallel.tensor.Placement`) the
global norm counts each split leaf once in total and each whole leaf once:
the sums of squares of the split leaves are summed over their axis's group.
LARS's trust ratios take a model-split leaf's full norms the same way.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..utils import span
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


def split_norm(grads: Mapping[str, torch.Tensor], split: Mapping[str, str], mesh) -> torch.Tensor:
    """The global norm of ``grads`` over a mesh that splits some of them
    (name -> "model" or "pipe"): the whole leaves' squares once, each axis's
    split leaves' squares summed over its group."""
    from ..parallel.collectives import _all_reduce_

    whole = [g for n, g in grads.items() if n not in split]
    total = sum(torch.sum(torch.square(t.float())) for t in whole) if whole else None
    for axis in ("model", "pipe"):
        mine = [g for n, g in grads.items() if split.get(n) == axis]
        if mesh is None or mesh.size(axis) == 1:
            continue
        ref = next(iter(grads.values()))
        sq = (sum(torch.sum(torch.square(t.float())) for t in mine) if mine else
              torch.zeros((), dtype=torch.float32, device=ref.device))
        sq = _all_reduce_(sq.reshape(1).clone(), mesh, axis)[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _order(layout: torch.optim.Optimizer, params: Mapping[str, torch.Tensor]):
    """The names of ``params`` in the order of ``layout``'s ``state_dict``
    indices (its groups' params, concatenated)."""
    names = {id(p): n for n, p in params.items()}
    return [names[id(p)] for g in layout.param_groups for p in g["params"]]


def state_by_name(inner_sd: Mapping, layout: torch.optim.Optimizer,
                  params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """An inner optimizer's ``state_dict`` whose layout is ``layout`` over
    ``params`` -> name -> its state entries."""
    order = _order(layout, params)
    return {order[int(i)]: dict(st) for i, st in inner_sd["state"].items()}


def state_dict_of(named: Mapping[str, Mapping[str, torch.Tensor]], layout: torch.optim.Optimizer,
                  params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`state_by_name`: ``layout`` (an optimizer over
    ``params`` that holds no state) filled with ``named`` state, as its
    ``state_dict``."""
    for n, st in named.items():
        layout.state[params[n]] = dict(st)
    return layout.state_dict()


class Optimizer:
    """The update of one training step over the named trainable params:
    clip (if ``max_norm``), set the rate from ``schedule`` at the update
    count, then step ``inner`` (:class:`LARS` or ``torch.optim.AdamW``).
    ``split`` and ``mesh``: the params split over the model or pipe axis
    (name -> axis), for the global norm; ``make_inner`` builds an inner
    optimizer of the same kind over other params (the layout of a
    checkpoint)."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], inner: torch.optim.Optimizer,
                 schedule: Schedule, max_norm: Optional[float] = None,
                 split: Optional[Mapping[str, str]] = None, mesh=None, make_inner=None):
        self.params = dict(params)
        self.inner, self.schedule, self.max_norm = inner, schedule, max_norm
        self.split, self.mesh, self.make_inner = dict(split or {}), mesh, make_inner
        self.count = 0

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, object]:
        """One update from ``grads`` (name -> grad of every trainable
        param). Returns ``{"grad_norm": norm before clipping (0-d tensor),
        "lr": this update's rate}``."""
        with span("vipant.optim"):
            names = list(self.params)
            gs = [grads[n] for n in names]
            with span("vipant.optim.clip"):
                norm = (split_norm(dict(zip(names, gs)), self.split, self.mesh) if self.split
                        else global_norm(gs))
                if self.max_norm:
                    gs = clip_by_global_norm(gs, float(self.max_norm), norm)
            lr = self.schedule(self.count)
            for group in self.inner.param_groups:
                group["lr"] = lr
            with span("vipant.optim.update"):
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

    def _layout(self) -> torch.optim.Optimizer:
        """The optimizer whose ``state_dict`` layout :meth:`state_dict` writes."""
        return self.inner

    def named_state_dict(self) -> dict:
        """``{"count", "state": name -> its entries}`` of :meth:`state_dict`
        (a collective where that is one)."""
        sd = self.state_dict()
        return {"count": sd["count"], "state": state_by_name(sd["inner"], self._layout(), self.params)}

    def load_named_state_dict(self, sd: Mapping) -> None:
        """Load ``{"count", "state": name -> entries}`` of every param of this
        optimizer."""
        layout = self.make_inner(dict(self.params))
        self.load_state_dict({"count": sd["count"],
                              "inner": state_dict_of(sd["state"], layout, self.params)})


def inner_factory(opt_cfg, reduce=None) -> Callable[[Mapping[str, torch.nn.Parameter]],
                                                    torch.optim.Optimizer]:
    """``optimizer`` config -> the builder of the inner optimizer (:class:`LARS`
    or ``torch.optim.AdamW``) over named params. ``reduce(p, sq)``: the full
    sum of squares of param ``p`` from this rank's ``sq`` (LARS's norms of a
    split leaf)."""
    if bool(opt_cfg.get("use_lars", False)):
        kw = dict(lr_weight=float(opt_cfg.get("lr_weight", 0.2)),
                  lr_bias=float(opt_cfg.get("lr_bias", 0.0048)), eta=float(opt_cfg.get("eta", 0.001)),
                  weight_decay=float(opt_cfg.get("weight_decay", 1e-6)), reduce=reduce)
        return lambda named: LARS(named.items(), **kw)
    betas = opt_cfg.get("betas", [0.9, 0.999])
    kw = dict(lr=float(opt_cfg.lr), betas=(float(betas[0]), float(betas[1])), eps=1e-8,
              weight_decay=float(opt_cfg.get("weight_decay", 0.0)))
    return lambda named: torch.optim.AdamW(list(named.values()), **kw)


def build_optimizer(opt_cfg, steps_per_epoch: int,
                    params: Mapping[str, torch.nn.Parameter], zero_mesh=None,
                    split: Optional[Mapping[str, str]] = None, mesh=None) -> Optimizer:
    """``optimizer`` config -> :class:`Optimizer` over ``params`` (the
    trainable ones, by name). ``zero_mesh``: a data mesh of more than one
    rank over which the optimizer state is split (ZeRO-1,
    :class:`..parallel.zero.ZeroOptimizer`). ``split`` and ``mesh``: the
    params split over the mesh's model or pipe axis (name -> axis)."""
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
    split = {n: a for n, a in (split or {}).items() if n in params}
    reduce = None
    if any(a == "model" for a in split.values()):
        from ..parallel.tensor import model_sumsq

        model_ids = {id(params[n]) for n, a in split.items() if a == "model"}
        reduce = lambda p, sq: model_sumsq(sq, mesh) if id(p) in model_ids else sq  # noqa: E731
    make_inner = inner_factory(opt_cfg, reduce)
    if zero_mesh is not None and zero_mesh.parallel:
        from ..parallel.zero import ZeroOptimizer

        return ZeroOptimizer(params, make_inner, schedule, max_norm, zero_mesh, split=split)
    return Optimizer(params, make_inner(dict(params)), schedule, max_norm, split=split, mesh=mesh,
                     make_inner=make_inner)
