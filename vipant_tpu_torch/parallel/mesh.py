"""The mesh of the port: one process a rank over ``torch.distributed``.

Counterpart of ``vipant_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a device mesh of four axes, ``data``, ``model``, ``pipe``
and ``seq``, and lets GSPMD place the arrays and insert the collectives.
Here each rank is a process on its own device. Rank r sits at the JAX
coordinate of r in the data-major layout ``reshape(data, model, pipe,
seq)``, and gets one process group for each axis above 1 that it lies on
(:class:`Mesh`). What GSPMD did is written out by hand:

- ``data`` (:mod:`.collectives`): :func:`shard_batch` hands a rank its rows
  of the global batch, the losses all-gather the embeddings, and the grads
  are averaged over the data group;
- ``model`` (:mod:`.tensor`): the sub-blocks' weights are split by head block
  and Megatron's column and row split, and the partial products are summed
  over the model group;
- ``pipe`` (:mod:`.pipeline`): each stage holds its layers of a stacked
  trunk, and microbatches pass between neighbouring stages;
- ``seq`` (:mod:`.sequence`): a stacked trunk's tokens are split, and the
  attention runs as a ring.

:func:`distributed_init` forms the process group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or the JAX launcher's (``NUM_PROCESSES``, ``PROCESS_ID``,
``COORDINATOR_ADDRESS``, as ``train.py`` reads them), with the backend the
caller names: NCCL by default on the card, gloo on the CPU. A group that
fails to form raises; nothing falls back to one rank or another backend.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model", "pipe", "seq")


def launcher_env() -> Optional[Dict[str, Any]]:
    """``{"world", "rank", "local_rank", "init_method"}`` from ``torchrun``'s
    environment, else from the JAX launcher's (whose local rank is ``rank``
    modulo the local cards); None outside a launcher."""
    env = os.environ
    if "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        init = f"tcp://{addr}:{port}" if addr and port else "env://"
    elif int(env.get("NUM_PROCESSES", "1")) > 1:  # the JAX launcher forms no group of one
        world, rank = int(env["NUM_PROCESSES"]), int(env.get("PROCESS_ID", "0"))
        coord = env.get("COORDINATOR_ADDRESS")
        if not coord:
            raise ValueError("NUM_PROCESSES > 1 needs COORDINATOR_ADDRESS (host:port)")
        init = f"tcp://{coord}"
    else:
        return None
    # the JAX launcher names no local rank: its processes fill each host's
    # cards in rank order
    local = env.get("LOCAL_RANK")
    local = int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)
    return {"world": world, "rank": rank, "local_rank": local, "init_method": init}


def default_backend(device: torch.device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_init(backend: Optional[str] = None, device: Any = "cuda",
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, timeout_s: float = 600.0) -> bool:
    """Form the default process group once per process (a group that exists
    is kept). ``init_method`` / ``world_size`` / ``rank`` given win over the
    launcher's environment; with neither there is nothing to form and this
    returns False. ``backend`` defaults to :func:`default_backend` of
    ``device``. Returns whether a group exists."""
    if dist.is_initialized():
        return True
    env = launcher_env()
    if world_size is None and env is None:
        return False
    world = int(world_size if world_size is not None else env["world"])
    rank = int(rank if rank is not None else env["rank"])
    init = init_method or (env["init_method"] if env is not None else None)
    if init is None:
        raise ValueError("a process group needs an init_method (tcp://host:port or file://path)")
    dist.init_process_group(backend or default_backend(device), init_method=init,
                            world_size=world, rank=rank, timeout=timedelta(seconds=timeout_s))
    return True


def launcher_device(device: Any) -> torch.device:
    """``"cuda"`` without an index is ``cuda:{LOCAL_RANK}`` under a launcher;
    anything else as given."""
    device = torch.device(device)
    env = launcher_env()
    if device.type == "cuda" and device.index is None and env is not None:
        return torch.device("cuda", env["local_rank"])
    return device


def coords_of(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s index on each axis in the data-major layout, ``rank =
    ((data * M + model) * P + pipe) * S + seq``: the JAX mesh's
    ``reshape(data, model, pipe, seq)`` of the device list."""
    out, r = {}, int(rank)
    for axis in reversed(AXES):
        out[axis] = r % sizes[axis]
        r //= sizes[axis]
    return out


def axis_ranks(rank: int, sizes: Dict[str, int], axis: str) -> List[int]:
    """The global ranks of ``rank``'s group along ``axis``, in the axis's
    order: every coordinate of ``rank`` but ``axis``'s held fixed."""
    stride = 1
    for a in reversed(AXES[AXES.index(axis) + 1:]):
        stride *= sizes[a]
    base = rank - coords_of(rank, sizes)[axis] * stride
    return [base + i * stride for i in range(sizes[axis])]


class Mesh:
    """The mesh as this process sees it: the sizes of the four axes
    (``data``, ``model``, ``pipe``, ``seq``), this process's global
    ``rank`` and its index on each axis (:meth:`index`), on ``device``;
    ``backend`` is the group's (None: one process, no group, nothing to
    communicate). :meth:`group` is the process group of an axis (None for
    the whole world, which the default group serves), :meth:`ranks` its
    global ranks. ``Mesh(2, 1, "gloo")`` is rank 1 of a data axis of 2."""

    def __init__(self, data: int = 1, rank: int = 0, backend: Optional[str] = None,
                 device: Any = "cpu", model: int = 1, pipe: int = 1, seq: int = 1,
                 groups: Optional[Dict[str, Any]] = None):
        self.data, self.model, self.pipe, self.seq = int(data), int(model), int(pipe), int(seq)
        self.rank, self.backend = int(rank), backend
        self.device = torch.device(device)
        self.coords = coords_of(self.rank, self.shape)
        self._groups = dict(groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model, "pipe": self.pipe, "seq": self.seq}

    @property
    def world(self) -> int:
        return self.data * self.model * self.pipe * self.seq

    def index(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def data_index(self) -> int:
        """This rank's coordinate on the data axis: its shard of the batch."""
        return self.coords["data"]

    def ranks(self, axis: str) -> List[int]:
        return axis_ranks(self.rank, self.shape, axis)

    def group(self, axis: str):
        """The process group of ``axis`` (None: the default group, when the
        axis spans the world)."""
        return self._groups.get(axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def distributed(self) -> bool:
        """A process group exists (of one rank or more): the grads pass the
        all-reduce."""
        return self.backend is not None

    @property
    def parallel(self) -> bool:
        """More than one data rank: the batch is split and losses gather it."""
        return self.data > 1

    def barrier(self) -> None:
        if self.distributed:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1 or a == "data")
        return f"Mesh({axes}, rank={self.rank}, backend={self.backend}, device={self.device})"


def _axis_groups(world: int, rank: int, sizes: Dict[str, int]) -> Dict[str, Any]:
    """One ``dist.new_group`` for each group of each axis above 1 (every rank
    forms every group, in the same order, as ``new_group`` requires); the
    ones this rank lies on. An axis that spans the world takes the default
    group."""
    out: Dict[str, Any] = {}
    for axis in AXES:
        if sizes[axis] == 1:
            continue
        if sizes[axis] == world:
            out[axis] = None
            continue
        mine = axis_ranks(rank, sizes, axis)
        for r0 in range(world):
            ranks = axis_ranks(r0, sizes, axis)
            if ranks[0] != r0:  # each group once, from its first rank
                continue
            g = dist.new_group(ranks)
            if ranks == mine:
                out[axis] = g
    return out


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, seq: int = 1,
              device: Any = "cpu") -> Mesh:
    """The mesh of this process. Under a launcher (or with a group formed
    already) the world is the group; without one the process is alone on
    it. ``data=-1`` takes ``world // (model * pipe * seq)``; an explicit
    product that differs from the world size raises (one process a rank:
    launch ``torchrun --nproc_per_node=N`` for N). ``pipe`` and ``seq`` do
    not combine (``vipant_tpu/train/trainer.py:110``), nor ``seq`` and
    ``model`` (``vipant_tpu/nn/layers.py:558-566``). On the card the
    process's current device is set to ``device`` before the group forms,
    so that every rank's collectives and CUDA context sit on its own card.
    A launcher's group is formed here on the device's default backend; to
    use another, form it first with :func:`distributed_init`."""
    model, pipe, seq = int(model), int(pipe), int(seq)
    if min(model, pipe, seq) < 1:
        raise ValueError(f"mesh axes must be >= 1: model={model}, pipe={pipe}, seq={seq}")
    if pipe > 1 and seq > 1:
        raise ValueError("mesh.pipe and mesh.seq cannot combine")
    if seq > 1 and model > 1:
        raise ValueError("seq and model cannot shard the same trunk: mesh.seq and mesh.model "
                         "cannot combine")
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:  # "cuda" alone is the current one
        torch.cuda.set_device(device)
    formed = distributed_init(device=device)
    world, rank = (dist.get_world_size(), dist.get_rank()) if formed else (1, 0)
    rest = model * pipe * seq
    if int(data) == -1:
        if world % rest:
            raise ValueError(f"{world} ranks do not divide into model={model} x pipe={pipe} x "
                             f"seq={seq}")
        data = world // rest
    if int(data) * rest != world:
        raise ValueError(f"mesh.data={data} must equal the number of ranks ({world}) divided by "
                         f"model x pipe x seq ({rest}): the port runs one process a rank "
                         "(torchrun --nproc_per_node=N, or mesh.data=-1)")
    sizes = {"data": int(data), "model": model, "pipe": pipe, "seq": seq}
    groups = _axis_groups(world, rank, sizes) if formed else {}
    return Mesh(int(data), rank, dist.get_backend() if formed else None, device, model=model,
                pipe=pipe, seq=seq, groups=groups)


def data_shard_info(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(shard_id, num_shards)`` of this process's slice of the ``data``
    axis: the host-side dataset sharding coordinates.

    Processes whose devices own the same data-axis coordinates form one
    data-parallel group and must load identical host batches: every model,
    pipe and seq rank of one data shard reads the same rows. So this is
    ``(data index, data size)``, not the rank; ``(0, 1)`` without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.data_index, mesh.data


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of a global batch (a tensor or array, or a tuple or
    list of them; None passes), on the mesh's device: rows ``[rank * b,
    (rank + 1) * b)`` with ``b = B / ranks``, as the JAX package's batch
    sharding lays the global batch over the data axis. B must divide."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh) for x in batch)
    if batch is None:
        return None
    x = batch if torch.is_tensor(batch) else torch.as_tensor(batch)
    rank, n = data_shard_info(mesh)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} ranks")
    b = x.shape[0] // n
    x = x[rank * b:(rank + 1) * b]
    return x.to(mesh.device) if mesh is not None else x


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Broadcast rank 0's params and buffers (BatchNorm statistics too) to
    every rank, in place, so that the replicas start equal after init and
    loading: over the whole world, before the model and pipe axes take
    their slices (:func:`.tensor.shard_model`). Nothing to do without a
    group of more than one rank."""
    if mesh is None or mesh.world == 1:
        return
    seen = set()
    for t in [*module.parameters(), *module.buffers()]:
        if id(t) not in seen:  # a tied tensor once
            seen.add(id(t))
            w = t.data.to(mesh.device) if (t.device.type == "cpu" and mesh.backend == "nccl") else t.data
            dist.broadcast(w, 0)
            if w is not t.data:
                t.data.copy_(w)


def attach(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Hand ``mesh`` to what reads it in a training forward: the task model
    (its losses gather the batch), the towers' BatchNorms (global
    statistics; a loss head's BatchNorm, Barlow's projector, sees the
    gathered batch already and is left as it is), and under a seq axis the
    stacked trunks, whose tokens it splits (:mod:`.sequence`)."""
    from ..nn.layers import Transformer
    from ..nn.losses import BatchNorm

    model.data_group = mesh
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm) and not name.startswith("loss."):
            module.data_group = mesh
        if isinstance(module, Transformer) and module.stacked and mesh is not None and mesh.seq > 1:
            module.seq = mesh


def seq_partial(model: torch.nn.Module, names) -> frozenset:
    """The names among ``names`` of the parameters of the trunks whose last
    forward ran over the seq ring (``rang``; a trunk whose tokens do not
    split runs whole): each rank's grads of them cover its tokens only, and
    the step sums them over the seq group."""
    from ..nn.layers import Transformer

    out = set()
    for mname, module in model.named_modules():
        if isinstance(module, Transformer) and module.seq is not None and module.rang:
            out |= {f"{mname}.{n}" for n, _ in module.named_parameters()}
    return frozenset(n for n in names if n in out)
