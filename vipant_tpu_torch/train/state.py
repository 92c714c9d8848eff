"""Train state: step, trainable and frozen params, optimizer state, rng.

Counterpart of ``vipant_tpu/train/state.py``. The JAX state is an
immutable pytree that each step returns anew; here the model's parameters
and the optimizer's buffers are updated in place and the state holds
references to them. ``buffers`` are the model's running statistics (the JAX
``batch_stats`` collection: Barlow's BatchNorm), which a training forward
updates in place. ``state_dict()`` gathers everything a resume needs, for
``torch.save`` (under ZeRO every rank takes part and rank 0 gets the full
optimizer state). ``mesh`` is the mesh (:mod:`..parallel.mesh`) whose data
ranks average the grads; None on one device. On a mesh whose ``model`` or
``pipe`` axis splits the params (``placement``), ``state_dict()`` is a
collective that gives the full reference-named tensors of the unsplit
model (``full_names``: its trainable and frozen names, in order), and the
optimizer state in the layout of the unsplit model's optimizer, so that a
checkpoint is the same file whatever the mesh; :meth:`load_state_dict`
takes this rank's slices of such a file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..optim.build import Optimizer, state_by_name, state_dict_of


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
    placement: Optional[Any] = None
    full_names: Optional[Tuple[List[str], List[str]]] = None

    @property
    def split(self) -> bool:
        return self.placement is not None and not self.placement.empty

    def state_dict(self) -> Dict[str, Any]:
        if not self.split:
            params = {k: p.detach() for k, p in self.trainable.items()}
            frozen = {k: p.detach() for k, p in self.frozen.items()}
            opt = self.optimizer.state_dict()
        else:
            pl, (tnames, fnames) = self.placement, self.full_names
            params = pl.full(self.trainable, tnames)
            frozen = pl.full(self.frozen, fnames)
            named = self.optimizer.named_state_dict()
            full = pl.full_state(named["state"], tnames, self.trainable)
            ghosts, layout = self._ghosts()
            opt = {"count": named["count"], "inner": state_dict_of(full, layout, ghosts)}
        return {
            "step": self.step,
            "params": params,
            "frozen_params": frozen,
            "opt_state": opt,
            "rng": self.generator.get_state(),
            "buffers": {k: b.detach() for k, b in self.buffers.items()},
        }

    def _ghosts(self) -> Tuple[Dict[str, nn.Parameter], torch.optim.Optimizer]:
        """Storage-free stand-ins of the unsplit model's trainable params,
        in order, and an optimizer over them: the layout of the unsplit
        model's optimizer state."""
        shapes = self.placement.shapes
        ghosts = {n: nn.Parameter(torch.empty(shapes[n], device="meta")) for n in self.full_names[0]}
        return ghosts, self.optimizer.make_inner(ghosts)

    def load_state_dict(self, sd: Mapping[str, Any], restore) -> None:
        """Restore from a :meth:`state_dict` (the full tensors): ``restore(own,
        src, what)`` copies each of ``own``'s tensors from ``src`` by name;
        a split state takes this rank's slices first."""
        params, frozen, opt = sd["params"], sd["frozen_params"], sd["opt_state"]
        if self.split:
            pl = self.placement
            params = {k: pl.local(k, v) for k, v in params.items() if pl.here(k)}
            frozen = {k: pl.local(k, v) for k, v in frozen.items() if pl.here(k)}
            ghosts, layout = self._ghosts()
            named = state_by_name(opt["inner"], layout, ghosts)
            self.optimizer.load_named_state_dict(
                {"count": opt["count"], "state": {
                    n: {k: v.to(self.trainable[n].device) if v.dim() else v for k, v in st.items()}
                    for n, st in pl.local_state(named).items()}})
        restore(self.trainable, params, "trainable param")
        restore(self.frozen, frozen, "frozen param")
        restore(self.buffers, sd.get("buffers", {}), "running statistic")
        if not self.split:
            self.optimizer.load_state_dict(opt)
        self.generator.set_state(sd["rng"])
        self.step = int(sd["step"])
