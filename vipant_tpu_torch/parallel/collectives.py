"""The collectives of the data axis: what GSPMD inserts in the JAX package.

The JAX step writes its losses over the global batch and XLA gathers the
sharded embeddings and sums the weight grads over the ``data`` axis
(``vipant_tpu/train/step.py:1-7``). Here each rank computes the same global
loss from embeddings gathered with :func:`gather_batch`, so each rank's
autograd gives ``ranks`` times its share of the grads (the gather's backward
sums the cotangents of every rank), and :func:`all_reduce_grads` takes the
mean over the ranks, which is the JAX grad. A loss that is not gathered
(``LMLossHead``) scales its rank's part to match (:mod:`..nn.losses`).

Every data-axis collective runs over the mesh's data group (the whole world
when the data axis is the mesh). The model axis has its own pair
(Megatron's f and g, :func:`copy_to` and :func:`reduce_from`), and the
pipeline and the ring their point-to-point exchange (:func:`exchange`).

The tensors go where they are: NCCL and gloo both take CUDA tensors for the
all-reduce, the broadcast and the all-gather (gloo's, probed on the card by
``chip_smoke.py``'s phase 22, copies through host memory itself). Two
transports are spelled out here:

- a host tensor in an NCCL group (an optimizer's step count) goes through
  the mesh's device;
- on gloo, a bf16 tensor is widened to fp32 on the wire, and an all-reduce
  rounds the fp32 sum once to bf16 (for two ranks, the bf16 sum's own
  rounding), whatever gloo's own bf16 sum does;
- gloo's point-to-point send and receive of a CUDA tensor go through a
  pinned host buffer (:func:`host_staged_exchange`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# bytes of one flattened bucket of the grads' all-reduce
BUCKET_BYTES = 32 << 20


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the backend communicates for ``x``: ``x`` itself, a copy on
    the card for a host tensor in an NCCL group, or an fp32 copy of a bf16
    tensor on gloo."""
    if x.device.type == "cpu" and mesh.backend == "nccl":
        return x.to(mesh.device)
    if x.dtype == torch.bfloat16 and mesh.backend == "gloo":
        return x.float()
    return x


def _alone(mesh: Mesh, axis: str) -> bool:
    """This rank is alone on ``axis`` in a world of several ranks: a
    collective over the axis has nothing to do (a world of one rank still
    runs it, on its group of one)."""
    return mesh.size(axis) == 1 and mesh.world > 1


def _all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis``, in place; returns it."""
    if _alone(mesh, axis):
        return x
    w = _wire(x, mesh)
    dist.all_reduce(w, group=mesh.group(axis))
    return x if w is x else x.copy_(w)


def broadcast_(x: torch.Tensor, src: int, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The ``x`` of the rank at index ``src`` of ``axis`` on every rank of
    that axis, in place; returns it."""
    if _alone(mesh, axis):
        return x
    w = _wire(x, mesh)
    dist.broadcast(w, mesh.ranks(axis)[src], group=mesh.group(axis))
    return x if w is x else x.copy_(w)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """[ranks * b, ...]: every rank's ``x`` [b, ...] along dim 0 in the axis's
    order."""
    if _alone(mesh, axis):
        return x.clone()
    w = _wire(x.contiguous(), mesh)
    out = torch.empty((mesh.size(axis) * w.shape[0], *w.shape[1:]), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w, group=mesh.group(axis))
    return out.to(x.device, x.dtype)


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
        r = ctx.mesh.data_index * ctx.rows
        return g[r:r + ctx.rows], None


def gather_batch(x: Optional[torch.Tensor], mesh: Optional[Mesh]) -> Optional[torch.Tensor]:
    """Every data rank's rows of ``x`` along dim 0, in the data axis's order,
    with gradient; ``x`` itself without a data axis of more than one rank
    (and None passes). Every rank must hold the same number of rows."""
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
    """The sum of ``x`` over the data ranks, a new tensor, with gradient (its
    backward sums the cotangents too): normalisers, BatchNorm's sums,
    metrics. ``x`` itself without a data axis of more than one rank."""
    if mesh is None or not mesh.parallel:
        return x
    return _AllReduceSum.apply(x, mesh)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the sum of the ranks' partial results in the forward,
    the cotangent as it is in the backward (every rank computes the same
    loss from the sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce_(x.detach().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the input as it is in the forward (every rank holds it
    whole), the sum of the ranks' cotangents in the backward (each rank's
    slice of the work sees only its part)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x``; its backward hands
    each rank the cotangent as it is."""
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """``x`` as it is; its backward sums the cotangents over ``axis``."""
    return _CopyTo.apply(x, mesh, axis)


def host_staged_exchange(send: Optional[torch.Tensor], dst: Optional[int],
                         recv: Optional[torch.Tensor], src: Optional[int], group=None) -> None:
    """gloo's point-to-point transport for CUDA tensors: ``send`` is copied
    to a pinned host buffer and sent to global rank ``dst``, while a pinned
    host buffer is received from ``src`` and copied into ``recv``; either
    side may be None. The send and the receive are posted together, so two
    ranks that exchange with each other cannot wait on one another."""
    reqs, staged = [], None
    if send is not None:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        reqs.append(dist.isend(host, dst, group=group))
    if recv is not None:
        staged = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        reqs.append(dist.irecv(staged, src, group=group))
    for r in reqs:
        r.wait()
    if recv is not None:
        recv.copy_(staged)


def exchange(mesh: Mesh, send: Optional[torch.Tensor] = None, dst: Optional[int] = None,
             recv: Optional[torch.Tensor] = None, src: Optional[int] = None) -> None:
    """Send ``send`` to global rank ``dst`` and receive ``recv`` (filled in
    place) from global rank ``src``, posted together; either side may be
    None. On NCCL the pair goes through ``batch_isend_irecv``; on gloo a
    host tensor goes as it is and a CUDA tensor through
    :func:`host_staged_exchange`."""
    send = send.contiguous() if send is not None else None
    if mesh.backend == "gloo" and ((send is not None and send.is_cuda)
                                   or (recv is not None and recv.is_cuda)):
        host_staged_exchange(send, dst, recv, src)
        return
    if mesh.backend == "nccl":
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, dst))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return
    reqs = []
    if send is not None:
        reqs.append(dist.isend(send, dst))
    if recv is not None:
        reqs.append(dist.irecv(recv, src))
    for r in reqs:
        r.wait()


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


def _bucketed(names: List[str], tensors: List[torch.Tensor], mesh: Mesh, axis: str,
              bucket_bytes: int, scale: Optional[int]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for idx in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _all_reduce_(flat, mesh, axis)
        if scale is not None:
            flat.div_(scale)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[names[i]] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


@torch.no_grad()
def all_reduce_grads(grads: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
                     bucket_bytes: int = BUCKET_BYTES, seq_sum=()) -> Dict[str, torch.Tensor]:
    """The mean over the data ranks of each grad (name -> tensor), through a
    few flattened buckets rather than a call a tensor; the grads named in
    ``seq_sum`` summed over the seq group first. Runs whenever a group
    exists, of one rank too (a sum over one rank and a division by 1 change
    no bit); without one, ``grads`` as given."""
    if mesh is None or not mesh.distributed:
        return dict(grads)
    grads = dict(grads)
    if seq_sum:
        names = [n for n in grads if n in seq_sum]
        grads.update(_bucketed(names, [grads[n] for n in names], mesh, "seq", bucket_bytes, None))
    names = list(grads)
    return _bucketed(names, [grads[n] for n in names], mesh, "data", bucket_bytes, mesh.data)
