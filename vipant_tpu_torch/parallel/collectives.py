"""The collectives of the data axis: what GSPMD inserts in the JAX package.

The JAX step writes its losses over the global batch and XLA gathers the
sharded embeddings and sums the weight grads over the ``data`` axis
(``vipant_tpu/train/step.py:1-7``). Here each rank computes the same global
loss from embeddings gathered with :func:`gather_batch`, so each rank's
autograd gives ``ranks`` times its share of the grads (the gather's backward
sums the cotangents of every rank), and :func:`all_reduce_grads` takes the
mean over the ranks, which is the JAX grad. A loss that is not gathered
(``LMLossHead``) scales its rank's part to match (:mod:`..nn.losses`).

Every collective here takes the tensors where they are: NCCL and gloo both
take CUDA tensors for the all-reduce, the broadcast and the all-gather used
here (gloo's, probed on the card by ``chip_smoke.py``'s phase 22, copies
through host memory itself); a host tensor in an NCCL group (an optimizer's
step count) goes through the mesh's device.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# bytes of one flattened bucket of the grads' all-reduce
BUCKET_BYTES = 32 << 20


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the backend communicates for ``x``: ``x`` itself, or a
    copy on the card for a host tensor in an NCCL group."""
    if x.device.type == "cpu" and mesh.backend == "nccl":
        return x.to(mesh.device)
    return x


def _all_reduce_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; returns it."""
    w = _wire(x, mesh)
    dist.all_reduce(w)
    return x if w is x else x.copy_(w)


def broadcast_(x: torch.Tensor, src: int, mesh: Mesh) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in place; returns it."""
    w = _wire(x, mesh)
    dist.broadcast(w, src)
    return x if w is x else x.copy_(w)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[ranks * b, ...]: every rank's ``x`` [b, ...] along dim 0 in rank order."""
    w = _wire(x.contiguous(), mesh)
    out = torch.empty((mesh.data * w.shape[0], *w.shape[1:]), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w)
    return out.to(x.device)


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0 whose backward sums the cotangents of every
    rank and hands this rank its rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.mesh)
        r = ctx.mesh.rank * ctx.rows
        return g[r:r + ctx.rows], None


def gather_batch(x: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[torch.Tensor]:
    """Every rank's rows of ``x`` along dim 0, in rank order, with gradient;
    ``x`` itself without a group of more than one rank (and None passes).
    Every rank must hold the same number of rows."""
    if x is None or mesh is None or not mesh.parallel:
        return x
    return _GatherBatch.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, a new tensor, with gradient (its
    backward sums the cotangents too): normalisers, BatchNorm's sums,
    metrics. ``x`` itself without a group of more than one rank."""
    if mesh is None or not mesh.parallel:
        return x
    return _AllReduceSum.apply(x, mesh)


def _buckets(tensors: List[torch.Tensor], limit: int) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and device of at most
    ``limit`` bytes (a larger tensor alone)."""
    out: List[List[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        k = (t.dtype, t.device)
        if not out or k != key or size + nbytes > limit:
            out.append([])
            size, key = 0, k
        out[-1].append(i)
        size += nbytes
    return out


@torch.no_grad()
def all_reduce_grads(grads: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
                     bucket_bytes: int = BUCKET_BYTES) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each grad (name -> tensor), through a few
    flattened buckets rather than a call a tensor. Runs whenever a group
    exists, of one rank too (a sum over one rank and a division by 1 change
    no bit); without one, ``grads`` as given."""
    if mesh is None or not mesh.distributed:
        return dict(grads)
    names = list(grads)
    tensors = [grads[n] for n in names]
    out: Dict[str, torch.Tensor] = {}
    for idx in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _all_reduce_(flat, mesh)
        flat.div_(mesh.data)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[names[i]] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out
