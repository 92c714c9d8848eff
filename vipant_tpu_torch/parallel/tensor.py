"""Where each parameter lives on the ``model`` and ``pipe`` axes, and the
model axis's lookups and products.

Counterpart of ``vipant_tpu/parallel/mesh.py:param_shardings`` (:161-300)
and ``shard_params`` (:304). The JAX package places each leaf with a
``NamedSharding`` and GSPMD runs the sliced products; here
:func:`shard_model` replaces each split ``Parameter`` of a built model by
this rank's slice, under its reference name, and marks the module that uses
it (``module.tp``: the mesh), whose forward then computes its part and sums
the partial results over the model group:

- the self-attention's ``in_proj_weight`` [3C, C] and ``in_proj_bias``
  keep the rank's head block of each of q, k and v ([3C/tp, C]), and
  ``out_proj.weight`` the matching input columns ([C, C/tp]);
- the MLP's ``c_fc`` keeps its output rows ([E/tp, C] and the bias) and
  ``c_proj`` its input columns ([C, E/tp]): Megatron's split;
- a token embedding keeps its vocabulary rows ([V/tp, C]): the lookup of
  the rows a rank holds, zeros elsewhere, summed over the group (Megatron's
  masked lookup, :func:`vocab_lookup`);
- the towers' final ``proj`` and the decoder's ``text_proj`` keep their
  rows ([C/tp, D]), each rank's product summed (:func:`row_product`).

A split needs whole heads (and E, V, C divisible by the model size);
everything else stays whole on every rank, as in JAX: position and class
embeddings, norms, the out and proj biases (added once, as ``bias / tp`` on
each rank). The JAX rule leaves a leaf below ``min_size`` (65,536 elements)
whole; the port splits every leaf its rule names, since its compute follows
the placement. The captioning decoder's blocks (self- and cross-attention,
MLP) and its vocabulary product, and the ResNet towers, whose JAX split
comes from GSPMD alone, stay whole and run on every model rank, which gives
the same result.

On the ``pipe`` axis a stacked trunk keeps the blocks of this rank's stage,
``L/S`` consecutive layers, under their reference names: the others become
:class:`Elsewhere` entries that hold nothing (:mod:`.pipeline`). Such a trunk
is not split over ``model``: a pipelined stage runs its blocks whole, as
JAX's does inside its manual mesh.

:class:`Placement` records each split parameter's rule and full shape, so
that checkpoints, exports and tests see the full reference-named tensors
whatever the mesh (:meth:`Placement.full`, :meth:`Placement.local`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .collectives import _all_gather, broadcast_, copy_to, reduce_from
from .mesh import Mesh


class Elsewhere(nn.Module):
    """A block of a pipelined trunk that another stage holds: no parameters
    here, and calling it is an error."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = int(stage)

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block lives on pipeline stage {self.stage}")


class Split(NamedTuple):
    """How a parameter is placed: ``axis`` "model" or "pipe"; ``rule`` "qkv"
    (each third of dim 0 in blocks), "rows" (dim 0 in blocks), "cols" (dim 1
    in blocks) or "stage" (whole, on pipe stage ``stage``); its full
    ``shape``."""

    axis: str
    rule: str
    shape: Tuple[int, ...]
    stage: int = 0


def _blocks(t: torch.Tensor, rule: str, n: int) -> List[torch.Tensor]:
    """The ``n`` slices of the full ``t`` under ``rule``, in rank order."""
    if rule == "rows":
        return list(t.chunk(n, dim=0))
    if rule == "cols":
        return list(t.chunk(n, dim=1))
    if rule == "qkv":  # [3C, ...]: rank i's head block of each of q, k, v
        thirds = t.reshape(3, t.shape[0] // 3, *t.shape[1:])
        return [s.reshape(-1, *t.shape[1:]) for s in thirds.chunk(n, dim=1)]
    raise ValueError(f"unknown split rule {rule!r}")


def _join(parts: List[torch.Tensor], rule: str) -> torch.Tensor:
    """The inverse of :func:`_blocks`."""
    if rule == "rows":
        return torch.cat(parts, dim=0)
    if rule == "cols":
        return torch.cat(parts, dim=1)
    thirds = [p.reshape(3, p.shape[0] // 3, *p.shape[1:]) for p in parts]
    full = torch.cat(thirds, dim=1)
    return full.reshape(-1, *full.shape[2:])


class Placement:
    """The splits of one model on ``mesh``: full name -> :class:`Split` of
    every parameter that is not whole on every rank; ``names``, every
    parameter's full name in the unsplit model's order (a tied one once),
    ``all_names`` with every name a tied one goes by, and their full
    ``shapes``."""

    def __init__(self, mesh: Optional[Mesh], splits: Dict[str, Split], names: List[str],
                 shapes: Dict[str, Tuple[int, ...]], all_names: Optional[List[str]] = None):
        self.mesh, self.splits, self.names, self.shapes = mesh, splits, names, shapes
        self.all_names = list(all_names if all_names is not None else names)

    @property
    def empty(self) -> bool:
        return not self.splits

    def here(self, name: str) -> bool:
        """This rank holds (a slice of) ``name``."""
        s = self.splits.get(name)
        return s is None or s.rule != "stage" or s.stage == self.mesh.index("pipe")

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor ``full`` of ``name`` (the
        full tensor itself where it is whole)."""
        s = self.splits.get(name)
        if s is None or s.rule == "stage":
            return full
        return _blocks(full, s.rule, self.mesh.model)[self.mesh.index("model")].contiguous()

    @torch.no_grad()
    def full(self, tensors: Mapping[str, torch.Tensor], names: Optional[Iterable[str]] = None
             ) -> Dict[str, torch.Tensor]:
        """The full tensors of ``names`` (default: every full name) from each
        rank's local ``tensors`` (name -> its slice, or the whole tensor):
        a collective, every rank calls it with the same names and gets every
        full tensor. A stage's leaves come from that stage's rank of the
        pipe group, a model split's slices from every rank of the model
        group."""
        out: Dict[str, torch.Tensor] = {}
        for n in (self.names if names is None else names):
            s = self.splits.get(n)
            if s is None:
                out[n] = tensors[n]
            elif s.rule == "stage":
                like = tensors.get(n)
                if like is None:
                    ref = next(iter(tensors.values()))
                    like = torch.empty(s.shape, dtype=ref.dtype, device=ref.device)
                buf = like.detach().clone().contiguous()
                out[n] = broadcast_(buf, s.stage, self.mesh, "pipe")
            else:
                t = tensors[n].detach().contiguous()
                parts = _all_gather(t[None], self.mesh, "model")
                out[n] = _join(list(parts), s.rule)
        return out


    @torch.no_grad()
    def full_state(self, state: Mapping[str, Mapping[str, torch.Tensor]], names: List[str],
                   params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
        """Optimizer state (name -> entries: a param-shaped buffer, or a
        scalar such as Adam's step) of this rank's ``params`` -> the full
        state of ``names``: a collective, as :meth:`full`. Every leaf of one
        optimizer has the same entries, so a rank reads a leaf's entries it
        does not hold off its own leaves; a leaf without state here (ZeRO's
        other owners) sends zeros, which only the ranks that hold its state
        read."""
        have = [n for n in params if state.get(n)]
        if not have:
            return {}
        q = max(have, key=lambda n: params[n].numel())
        like = {k: (v.shape == params[q].shape, v.dtype, v.device) for k, v in state[q].items()}
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for n in names:
            s = self.splits.get(n)
            own = state.get(n) or {}
            entries = {}
            for k, (shaped, dtype, device) in like.items():
                if not shaped:  # a scalar: the same on every rank
                    entries[k] = own[k] if k in own else state[q][k].clone()
                    continue
                if s is None:
                    entries[k] = own[k] if k in own else torch.zeros(self.shapes[n], dtype=dtype,
                                                                     device=device)
                elif s.rule == "stage":
                    buf = (own[k].clone() if k in own else
                           torch.zeros(s.shape, dtype=dtype, device=device)).contiguous()
                    entries[k] = broadcast_(buf, s.stage, self.mesh, "pipe")
                else:
                    t = own[k] if k in own else torch.zeros_like(params[n], dtype=dtype)
                    entries[k] = _join(list(_all_gather(t.contiguous()[None], self.mesh, "model")),
                                       s.rule)
            out[n] = entries
        return out

    def local_state(self, state: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The inverse of :meth:`full_state` on one rank: each entry of a
        leaf this rank holds, sliced as the leaf is."""
        out = {}
        for n, entries in state.items():
            if not self.here(n):
                continue
            full = self.shapes.get(n)
            out[n] = {k: (self.local(n, v) if tuple(v.shape) == tuple(full) else v)
                      for k, v in entries.items()}
        return out


def _set_param(module: nn.Module, attr: str, value: torch.Tensor, memo: Dict[int, nn.Parameter]):
    old = module._parameters[attr]
    new = memo.get(id(old))
    if new is None:
        new = nn.Parameter(value.detach().clone().contiguous(), requires_grad=old.requires_grad)
        memo[id(old)] = new
    module._parameters[attr] = new


def _under(name: str, prefixes: Iterable[str]) -> bool:
    return any(name == p or name.startswith(p + ".") for p in prefixes)


def shard_model(model: nn.Module, mesh: Optional[Mesh],
                skip: Iterable[str] = ("decoder",)) -> Placement:
    """Split ``model``'s parameters in place for ``mesh`` (see the module
    docstring) and return the :class:`Placement`. Modules under ``skip``
    (the captioning decoder's blocks) stay whole. A parameter tied to
    several modules (siamese) is replaced by one new ``Parameter`` in every
    one of them. Without a model or pipe axis above 1 nothing changes."""
    from ..nn.layers import MLP, MultiHeadAttention, Transformer
    from ..nn.seqgen import SeqGenerationHead
    from ..nn.stages import GPTPostEncoder, GPTPreEncoder, ViTPostEncoder

    names = [n for n, _ in model.named_parameters(remove_duplicate=False)]
    seen, order = set(), []
    for n, p in model.named_parameters(remove_duplicate=False):
        if id(p) not in seen:
            seen.add(id(p))
            order.append(n)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters(remove_duplicate=False)}
    splits: Dict[str, Split] = {}
    if mesh is None or (mesh.model == 1 and mesh.pipe == 1):
        return Placement(mesh, splits, order, shapes, names)
    skip = tuple(skip)
    memo: Dict[int, nn.Parameter] = {}
    pipelined: List[str] = []
    tp, me = mesh.model, mesh.index("model")

    def split(module, mname, attr, rule):
        full = module._parameters[attr]
        for n in names:  # every name the tensor goes by (a tied one has several)
            if n.endswith("." + attr) and _same(model, n, full):
                splits[n] = Split("model", rule, tuple(full.shape))
        _set_param(module, attr, _blocks(full.data, rule, tp)[me], memo)

    if mesh.pipe > 1:
        S, s = mesh.pipe, mesh.index("pipe")
        for mname, module in model.named_modules():
            if isinstance(module, Transformer) and getattr(module, "stacked", False):
                L = len(module.resblocks)
                if L % S:
                    raise ValueError(f"{mname}: {L} layers do not divide into {S} pipeline stages")
                per = L // S
                for i in range(L):
                    stage = i // per
                    for pn, p in module.resblocks[i].named_parameters():
                        splits[f"{mname}.resblocks.{i}.{pn}"] = Split("pipe", "stage", tuple(p.shape),
                                                                      stage)
                    if stage != s:
                        module.resblocks[i] = Elsewhere(stage)
                module.pipe = mesh
                pipelined.append(mname)
    if tp > 1:
        for mname, module in model.named_modules():
            if _under(mname, pipelined):
                continue
            if isinstance(module, (MultiHeadAttention, MLP)) and _under(mname, skip):
                continue
            if isinstance(module, MultiHeadAttention) and not module.cross and module.heads % tp == 0:
                split(module, mname, "in_proj_weight", "qkv")
                split(module, mname, "in_proj_bias", "qkv")
                split(module.out_proj, mname + ".out_proj", "weight", "cols")
                module.tp = mesh
            elif isinstance(module, MLP) and module.c_fc.out_features % tp == 0:
                split(module.c_fc, mname + ".c_fc", "weight", "rows")
                split(module.c_fc, mname + ".c_fc", "bias", "rows")
                split(module.c_proj, mname + ".c_proj", "weight", "cols")
                module.tp = mesh
            elif isinstance(module, GPTPreEncoder) and module.token_embedding.weight.shape[0] % tp == 0:
                split(module.token_embedding, mname + ".token_embedding", "weight", "rows")
                module.tp = mesh
            elif isinstance(module, (ViTPostEncoder, GPTPostEncoder)) and module.proj.shape[0] % tp == 0:
                split(module, mname, "proj", "rows")
                module.tp = mesh
            elif isinstance(module, SeqGenerationHead):
                if module.text_proj.shape[0] % tp == 0:
                    split(module, mname, "text_proj", "rows")
                if module.token_embedding.shape[0] % tp == 0:
                    split(module, mname, "token_embedding", "rows")
                module.tp = mesh
    return Placement(mesh, splits, order, shapes, names)


def _same(model: nn.Module, name: str, p: torch.Tensor) -> bool:
    mod, _, attr = name.rpartition(".")
    try:
        return model.get_submodule(mod)._parameters.get(attr) is p
    except AttributeError:
        return False


# ----------------------------------------------------- the model axis's ops
def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``table[ids]`` for a table whose rows may be split over the model
    axis: this rank looks up the ids its rows hold, zeros elsewhere, and the
    group sums (exact: one rank holds each id)."""
    if mesh is None or mesh.model == 1:
        return table[ids]
    rows = table.shape[0]
    lo = mesh.index("model") * rows
    local = ids - lo
    hit = (local >= 0) & (local < rows)
    out = table[torch.where(hit, local, torch.zeros_like(local))] * hit[..., None].to(table.dtype)
    return reduce_from(out, mesh)


def row_product(x: torch.Tensor, w: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x @ w_full`` for a ``w_full`` [C, D] whose rows may be split over the
    model axis (``w`` this rank's [C/tp, D]): this rank's columns of ``x``
    times its rows in fp32, summed over the group and rounded once to x's
    dtype, as the whole product rounds its fp32 sum; ``x`` is whole on every
    rank, so its grad is summed too (Megatron's f)."""
    if mesh is None or mesh.model == 1:
        return x @ w.to(x.dtype)
    rows = w.shape[0]
    lo = mesh.index("model") * rows
    xs = copy_to(x, mesh)[..., lo:lo + rows]
    return reduce_from(xs.float() @ w.float(), mesh).to(x.dtype)


def model_sumsq(sq: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A sum of squares of a model-split leaf's slice, summed over the model
    group: the full leaf's."""
    if mesh is None or mesh.model == 1:
        return sq
    from .collectives import _all_reduce_

    return _all_reduce_(sq.clone(), mesh, "model")

