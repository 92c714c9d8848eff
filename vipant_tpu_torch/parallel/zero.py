"""ZeRO-1: the optimizer state split over the ranks of the ``data`` axis.

Counterpart of ``vipant_tpu/parallel/zero.py``. The JAX package shards each
large optimizer-state leaf (LARS momentum, Adam ``mu`` / ``nu``) 1/N along a
free dim over the data axis and lets GSPMD turn the grads' all-reduce into a
reduce-scatter and the update into an all-gather of the params. Here each
rank owns whole leaves: the leaves of at least ``min_size`` elements are
dealt to the ranks by size (the largest first, each to the rank holding the
fewest bytes so far), the smaller ones stay with every rank, as in JAX.
Every rank gets the mean grads (:func:`.collectives.all_reduce_grads`),
clips by their global norm, updates the leaves it holds state for, and then
each owner broadcasts its updated leaves. Owning whole leaves keeps LARS's
per-leaf trust ratios exact, where splitting a leaf would not; the numbers
are those of the replicated optimizer.

A checkpoint holds the full state in the replicated optimizer's format
(gathered to rank 0 by :meth:`ZeroOptimizer.state_dict`), so a run with
ZeRO and one without resume from each other (the JAX rule of
``tests/test_zero.py:135``). With one rank there is nothing to split and
:func:`..optim.build_optimizer` builds the plain optimizer, as the JAX
package leaves a one-device state as it is.

On a mesh with a ``model`` or ``pipe`` axis the owners are dealt over the
data group among each rank's own leaves (its slices and its stage's layers),
as the JAX package shards each leaf's free dim over ``data`` on top of its
model or pipe placement (``vipant_tpu/parallel/zero.py:14-16``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch

from ..optim.build import Optimizer
from .collectives import broadcast_
from .mesh import Mesh

MIN_SIZE = 1 << 14  # leaves smaller than this stay with every rank (JAX's min_size)


def assign_owners(sizes: Mapping[str, int], ranks: int, min_size: int = MIN_SIZE
                  ) -> Dict[str, Optional[int]]:
    """Name -> the rank that holds its optimizer state, or None for a leaf
    every rank holds (fewer than ``min_size`` elements). The same on every
    rank: the largest leaves first (ties in the given order), each to the
    rank with the fewest elements so far (ties to the lowest rank)."""
    load = [0] * ranks
    owners: Dict[str, Optional[int]] = {n: None for n in sizes}
    big = sorted((n for n in sizes if sizes[n] >= min_size), key=lambda n: -sizes[n])
    for n in big:
        r = min(range(ranks), key=lambda i: (load[i], i))
        owners[n] = r
        load[r] += sizes[n]
    return owners


class ZeroOptimizer(Optimizer):
    """:class:`..optim.build.Optimizer` whose inner optimizer holds the state
    of this rank's leaves only. ``make_inner`` builds the inner optimizer
    over named params. Its ``state_dict`` is a collective: every rank calls
    it."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter],
                 make_inner: Callable[[Mapping[str, torch.nn.Parameter]], torch.optim.Optimizer],
                 schedule, max_norm: Optional[float], mesh: Mesh, min_size: int = MIN_SIZE,
                 split: Optional[Mapping[str, str]] = None):
        self.owners = assign_owners({n: p.numel() for n, p in params.items()}, mesh.data, min_size)
        self.local = [n for n in params if self.owners[n] in (None, mesh.data_index)]
        super().__init__(params, make_inner({n: params[n] for n in self.local}), schedule, max_norm,
                         split=split, mesh=mesh, make_inner=make_inner)

    def _update(self, grads: Mapping[str, torch.Tensor]) -> None:
        for n in self.local:
            self.params[n].grad = grads[n]
        self.inner.step()
        for n in self.local:
            self.params[n].grad = None
        self._broadcast_owned()

    @torch.no_grad()
    def _broadcast_owned(self) -> None:
        """Each owner's updated leaves to every rank: one flattened
        broadcast an owner and dtype."""
        groups: Dict[tuple, list] = {}
        for n, owner in self.owners.items():
            if owner is not None:
                groups.setdefault((owner, self.params[n].dtype), []).append(self.params[n])
        for (owner, _), ps in groups.items():
            flat = torch.cat([p.data.reshape(-1) for p in ps]) if owner == self.mesh.data_index else \
                torch.empty(sum(p.numel() for p in ps), dtype=ps[0].dtype, device=ps[0].device)
            broadcast_(flat, owner, self.mesh)
            if owner != self.mesh.data_index:
                off = 0
                for p in ps:
                    p.data.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()

    # ------------------------------------------------------------ checkpoints
    def _entry_specs(self) -> Dict[str, Dict[str, tuple]]:
        """Each owned leaf's state entries as ``name -> key -> (shape, dtype,
        device)``, known on every rank without asking the owners: every leaf
        of one optimizer has the same entries, each of its param's shape
        (LARS's momentum, Adam's moments) or a scalar (Adam's step), so they
        are read off this rank's largest leaf with state."""
        have = [m for m in self.local if self.params[m] in self.inner.state]
        if not have:  # no update yet, on any rank
            return {n: {} for n in self.owners}
        q = self.params[max(have, key=lambda m: self.params[m].numel())]
        like = sorted(self.inner.state[q].items())
        return {n: {k: ((tuple(p.shape), v.dtype, p.device) if v.shape == q.shape else
                        (tuple(v.shape), v.dtype, v.device)) for k, v in like}
                for n, p in self.params.items() if self.owners[n] is not None}

    @torch.no_grad()
    def _gather_owned(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every owned leaf's state on rank 0, each owner sending all of its
        leaves' entries in one flattened broadcast a dtype; the other ranks
        keep their own leaves' only."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        specs = self._entry_specs()
        for owner in range(self.mesh.data):
            names = [n for n, o in self.owners.items() if o == owner]
            mine, keep = owner == self.mesh.data_index, self.mesh.data_index in (owner, 0)
            groups: Dict[torch.dtype, list] = {}
            for n in names:
                for k, spec in specs[n].items():
                    groups.setdefault(spec[1], []).append((n, k, spec))
            got: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in names}
            for dtype, entries in groups.items():
                dev = self.params[names[0]].device
                flat = (torch.cat([self.inner.state[self.params[n]][k].reshape(-1).to(dev)
                                   for n, k, _ in entries]) if mine else
                        torch.empty(sum(math.prod(sh) for _, _, (sh, _, _) in entries), dtype=dtype,
                                    device=dev))
                broadcast_(flat, owner, self.mesh)
                if keep:
                    off = 0
                    for n, k, (shape, _, device) in entries:
                        size = math.prod(shape)
                        got[n][k] = flat[off:off + size].view(shape).to(device).clone()
                        off += size
            if keep:
                out.update(got)
        return out

    def _layout(self) -> torch.optim.Optimizer:
        """An optimizer over every param, never stepped: the replicated
        optimizer, whose ``state_dict`` format the checkpoints keep."""
        return self.make_inner(dict(self.params))

    def state_dict(self) -> dict:
        """The full state in the replicated optimizer's format: every rank
        takes part, data index 0 gets every leaf's state (the others their
        own and the small leaves')."""
        layout = self._layout()
        for n, owner in self.owners.items():
            if owner is None and self.params[n] in self.inner.state:
                layout.state[self.params[n]] = self.inner.state[self.params[n]]
        for n, st in self._gather_owned().items():
            if st:
                layout.state[self.params[n]] = st
        return {"count": self.count, "inner": layout.state_dict()}

    def load_state_dict(self, sd: Mapping) -> None:
        """Load a full state (of a run with ZeRO or without) and keep this
        rank's leaves' state."""
        self.count = int(sd["count"])
        layout = self._layout()
        layout.load_state_dict(sd["inner"])
        self.inner.state.clear()
        for n in self.local:
            p = self.params[n]
            if p in layout.state:
                self.inner.state[p] = layout.state[p]
