"""Cross-tower parameter ties: the siamese mechanism.

Counterpart of ``vipant_tpu/nn/tying.py``. The reference shares module
objects between towers with ``keep_hp=True`` (``replace_modules``,
`reference/cvap/model/cvalp.py:147-180`): the destination keeps its own
hyperparameters (a patch stride, a position grid) and takes the source's
weights. The JAX package substitutes the source's arrays for the
destination's inside the differentiated step. Here a tie makes each
``Parameter`` of the destination stage the source's own object, the
destination module staying in place with its settings: the forward of
either tower reads the one tensor, the backward sums both towers' grads
into it, and ``named_parameters()`` yields it once, under the source's name
(the JAX trainer's tree pruned of the destinations, ``prune_tied``).

A tie ``(dst, src)`` names two stages as ``"<tower>/<stage>"`` (or a whole
tower). Every parameter must match its source in name and shape; a tie
whose shapes differ raises, naming both. The one exception is a ViT's
``misc`` stage (``CLIPMisc``), whose positional embedding is stored at its
tower's grid: tied, the destination stores the source's grid and re-grids
it to its own at every forward (the JAX tower's ``misc_stored_grid``, which
the JAX package's builders never set, so its misc tie fails at the first
apply when the grids differ).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from torch import nn

Tie = Tuple[str, str]


def _module(model: nn.Module, path: str) -> nn.Module:
    return model.get_submodule(path.replace("/", "."))


def tie_parameters(model: nn.Module, ties: Sequence[Tie]) -> None:
    """Make each destination stage's parameters its source's, in place (see
    the module docstring)."""
    from .stages import CLIPMisc

    for dst, src in ties:
        d, s = _module(model, dst), _module(model, src)
        dp = dict(d.named_parameters(remove_duplicate=False))
        sp = dict(s.named_parameters(remove_duplicate=False))
        if set(dp) != set(sp):
            raise ValueError(f"tie {dst} <- {src}: the stages hold different parameters "
                             f"{sorted(set(dp) ^ set(sp))}")
        regrid = [m for m in (d, s) if isinstance(m, CLIPMisc)]
        for name, p in dp.items():
            q = sp[name]
            if p.shape != q.shape and not (len(regrid) == 2 and d.stored_grid is not None
                                           and s.stored_grid is not None):
                raise ValueError(f"tie {dst}/{name} <- {src}/{name}: shapes "
                                 f"{tuple(p.shape)} and {tuple(q.shape)} differ")
        if len(regrid) == 2 and d.stored_grid is not None:
            d.stored_grid = s.stored_grid  # keep_hp: the target grid stays the tower's
        for name, q in sp.items():
            owner, _, leaf = name.rpartition(".")
            setattr(d.get_submodule(owner) if owner else d, leaf, q)


def tied_names(model: nn.Module) -> Dict[str, str]:
    """Each destination parameter name -> the name ``named_parameters()``
    gives its (shared) tensor."""
    first: Dict[int, str] = {}
    out: Dict[str, str] = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        if id(p) in first:
            out[name] = first[id(p)]
        else:
            first[id(p)] = name
    return out

