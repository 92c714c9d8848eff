"""Pipeline parallelism (GPipe) over the ``pipe`` axis.

Counterpart of ``vipant_tpu/parallel/pipeline.py``. A stacked trunk
(``model.*.stacked``) under ``mesh.pipe = S > 1`` keeps on each pipe rank
the ``L/S`` consecutive layers of its stage (:func:`..parallel.tensor.shard_model`),
and :func:`gpipe` runs it as GPipe does: the batch in ``M`` microbatches,
all forwards first, then all backwards. Between neighbouring stages the
activations go forward and their grads come back by point-to-point exchange
(:func:`..parallel.collectives.exchange`). The token-pack mask reaches every
stage, as JAX's ``consts`` do. The last stage's outputs are broadcast to
every pipe rank (JAX psums the stages' outputs, only the last being
nonzero), so everything after the trunk runs whole on every rank, and the
trunk input's grad is summed over the pipe group (only stage 0 adds
anything), so the parameters before the trunk get the same grads on every
rank.

The JAX package also keeps a ``[L, ...]`` stacked layout of the trunk's
parameters for GSPMD; the port keeps the unrolled layers under their
reference names, and reads a stacked JAX tree by unstacking it
(:func:`unstack_block_tree`, used by :mod:`..ckpt.from_jax`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .collectives import _all_reduce_, broadcast_, exchange
from .mesh import Mesh


def default_microbatches(b_loc: int, s: int) -> int:
    """2S microbatches, else S, else the largest divisor of the batch up to
    2S (``_default_microbatches``, :60-70)."""
    for m in (2 * s, s):
        if b_loc % m == 0:
            return m
    for m in range(min(2 * s, b_loc), 0, -1):
        if b_loc % m == 0:
            return m
    return 1


class _GPipe(torch.autograd.Function):
    """The schedule of one pipelined trunk call. ``run(h, mask)`` applies
    this stage's layers; ``params`` are their trainable parameters, whose
    grads the backward returns."""

    @staticmethod
    def forward(ctx, run, mesh, M, x, mask, *params):
        S, s = mesh.pipe, mesh.index("pipe")
        ranks = mesh.ranks("pipe")
        train = any(ctx.needs_input_grad)
        xs = x.detach().chunk(M)
        ins, outs = [], []
        for m in range(M):
            if s == 0:
                h = xs[m]
            else:
                h = torch.empty_like(xs[m])
                exchange(mesh, recv=h, src=ranks[s - 1])
            if train:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run(h, mask)
            else:
                y = run(h, mask)
            if s < S - 1:
                exchange(mesh, send=y.detach(), dst=ranks[s + 1])
            ins.append(h)
            outs.append(y)
        out = torch.cat([y.detach() for y in outs]) if s == S - 1 else torch.empty_like(x)
        broadcast_(out, S - 1, mesh, "pipe")
        if train:
            ctx.mesh, ctx.M, ctx.stage = mesh, M, (ins, outs, params)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, M = ctx.mesh, ctx.M
        ins, outs, params = ctx.stage
        del ctx.stage
        S, s = mesh.pipe, mesh.index("pipe")
        ranks = mesh.ranks("pipe")
        gs = g.contiguous().chunk(M)
        dxs: List[Optional[torch.Tensor]] = [None] * M
        dps: List[Optional[torch.Tensor]] = [None] * len(params)
        for m in range(M):
            if s == S - 1:
                dy = gs[m]
            else:
                dy = torch.empty_like(outs[m])
                exchange(mesh, recv=dy, src=ranks[s + 1])
            grads = torch.autograd.grad(outs[m], [ins[m], *params], dy, allow_unused=True)
            if s > 0:
                exchange(mesh, send=grads[0], dst=ranks[s - 1])
            else:
                dxs[m] = grads[0]
            for i, d in enumerate(grads[1:]):
                if d is not None:
                    dps[i] = d if dps[i] is None else dps[i] + d
        dx = torch.cat(dxs) if s == 0 else torch.zeros_like(g)
        _all_reduce_(dx, mesh, "pipe")
        return (None, None, None, dx, None, *dps)


def gpipe(run: Callable, stage: torch.nn.Module, x: torch.Tensor, mesh: Mesh,
          mask: Optional[torch.Tensor] = None, n_micro: Optional[int] = None) -> torch.Tensor:
    """Apply a pipelined trunk to ``x`` [B, ...] (whole on every pipe rank):
    ``run(h, mask)`` is this stage's layers, ``stage`` the module that holds
    their parameters. ``n_micro``: the microbatch count (``mesh.microbatches``
    or ``model.*.pipe_microbatches``), else :func:`default_microbatches`.
    Returns the trunk's output, whole on every pipe rank."""
    B = x.shape[0]
    M = int(n_micro) if n_micro else default_microbatches(B, mesh.pipe)
    if B % M:
        raise ValueError(f"batch {B} does not divide into {M} microbatches")
    params = [p for p in stage.parameters() if p.requires_grad] if torch.is_grad_enabled() else []
    return _GPipe.apply(run, mesh, M, x, mask, *params)


# ---------------------------------------------------------------------------
# layout converters: the JAX package's stacked ``blocks`` subtree
# ---------------------------------------------------------------------------


def is_stacked_blocks(d: Any) -> bool:
    """A ``StackedTransformer`` ``blocks`` subtree: a dict (not of unrolled
    ``block_{i}`` entries) whose array leaves share one leading layer axis
    (``vipant_tpu/parallel/pipeline.py:is_stacked_blocks``)."""
    if not isinstance(d, dict) or any(str(k).startswith("block_") for k in d):
        return False
    leaves = _leaves(d)
    if not leaves:
        return False
    dims = {np.shape(x)[0] if np.ndim(x) >= 1 else None for x in leaves}
    return len(dims) == 1 and None not in dims


def _leaves(d: Any) -> list:
    if isinstance(d, dict):
        return [x for v in d.values() for x in _leaves(v)]
    return [d]


def _index(d: Any, i: int) -> Any:
    if isinstance(d, dict):
        return {k: _index(v, i) for k, v in d.items()}
    return np.asarray(d)[i]


def unstack_block_tree(stacked: Dict[str, Any]) -> Dict[str, Any]:
    """``{param: [L, ...]}`` -> ``{"block_{i}": {param: [...]}}`` (the inverse
    of the JAX ``stack_block_tree``, :156)."""
    L = int(np.shape(_leaves(stacked)[0])[0])
    return {f"block_{i}": _index(stacked, i) for i in range(L)}


def unstack_in_tree(tree: Any) -> Any:
    """Every stacked ``blocks`` subtree of a JAX param tree replaced by its
    unrolled ``block_{i}`` children (``adapt_trunk_layout`` towards the
    unrolled layout, :183, and ``unstack_in_tree``)."""
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "blocks" and is_stacked_blocks(v):
            out.update(unstack_block_tree(v))
        else:
            out[k] = unstack_in_tree(v)
    return out
