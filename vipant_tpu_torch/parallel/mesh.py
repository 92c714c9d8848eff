"""The data mesh of the port: one process a rank over ``torch.distributed``.

Counterpart of ``vipant_tpu/parallel/mesh.py:25-155``. The JAX package runs
one SPMD program over a device mesh and lets GSPMD place the batch and insert
the collectives. Here each rank of the ``data`` axis is a process on its own
device with a full replica of the params; :func:`shard_batch` hands it its
rows of the global batch and :mod:`.collectives` does what GSPMD did: the
all-gather of the embeddings before a global-batch loss, and the mean of the
grads over the ranks (the psum of the weight grads).

:func:`distributed_init` forms the process group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or the JAX launcher's (``NUM_PROCESSES``, ``PROCESS_ID``,
``COORDINATOR_ADDRESS``, as ``train.py`` reads them), with the backend the
caller names: NCCL by default on the card, gloo on the CPU. A group that
fails to form raises; nothing falls back to one rank or another backend.

Only the ``data`` axis is ported: ``model``, ``pipe`` and ``seq`` above 1
are refused (ROADMAP.md queue A, A15-rest).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# the ROADMAP.md queue-A item that ports the model, pipe and seq axes
REST = "A15-rest"


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


class Mesh:
    """The ``data`` axis as this process sees it: ``data`` ranks, this one
    ``rank``, on ``device``; ``backend`` is the group's (None: one process,
    no group, nothing to communicate)."""

    def __init__(self, data: int = 1, rank: int = 0, backend: Optional[str] = None,
                 device: Any = "cpu"):
        self.data, self.rank, self.backend = int(data), int(rank), backend
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": 1, "pipe": 1, "seq": 1}

    @property
    def distributed(self) -> bool:
        """A process group exists (of one rank or more): the grads pass the
        all-reduce."""
        return self.backend is not None

    @property
    def parallel(self) -> bool:
        """More than one rank: the batch is split and losses gather it."""
        return self.data > 1

    def barrier(self) -> None:
        if self.distributed:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, rank={self.rank}, backend={self.backend}, device={self.device})"


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, seq: int = 1,
              device: Any = "cpu") -> Mesh:
    """The mesh of this process. Under a launcher (or with a group formed
    already) the ``data`` axis is the group; without one the process is
    alone on it. ``data=-1`` takes the world size and an explicit ``data``
    must equal it (one process a rank: launch ``torchrun
    --nproc_per_node=N`` for N). On the card the process's current device
    is set to ``device`` before the group forms, so that every rank's
    collectives and CUDA context sit on its own card. A launcher's group is
    formed here on the device's default backend; to use another, form it
    first with :func:`distributed_init`. ``model``, ``pipe`` and ``seq``
    above 1 raise ``NotImplementedError``."""
    for name, n in (("model", model), ("pipe", pipe), ("seq", seq)):
        if int(n) > 1:
            raise NotImplementedError(
                f"mesh.{name} > 1 is not ported yet: the port runs the data axis only "
                f"(ROADMAP.md queue A, {REST})")
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:  # "cuda" alone is the current one
        torch.cuda.set_device(device)
    formed = distributed_init(device=device)
    world, rank = (dist.get_world_size(), dist.get_rank()) if formed else (1, 0)
    if int(data) not in (-1, world):
        raise ValueError(f"mesh.data={data} must equal the number of ranks ({world}): the port runs "
                         "one process a rank (torchrun --nproc_per_node=N, or mesh.data=-1)")
    return Mesh(world, rank, dist.get_backend() if formed else None, device)


def data_shard_info(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(shard_id, num_shards)`` of this process's slice of the ``data``
    axis: the host-side dataset sharding coordinates.

    Processes whose devices own the same data-axis coordinates form one
    data-parallel group and must load identical host batches (the data axis
    replicates over them, as the ``model`` axis will once it is ported).
    With the data axis alone, every rank is its own group: ``(rank,
    world)``; ``(0, 1)`` without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.rank, mesh.data


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
    loading. Nothing to do without a group of more than one rank."""
    if mesh is None or not mesh.parallel:
        return
    from .collectives import broadcast_

    seen = set()
    for t in [*module.parameters(), *module.buffers()]:
        if id(t) not in seen:  # a tied tensor once
            seen.add(id(t))
            broadcast_(t.data, 0, mesh)


def attach(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Hand ``mesh`` to what reads it in a training forward: the task model
    (its losses gather the batch) and the towers' BatchNorms (global
    statistics); a loss head's BatchNorm (Barlow's projector) sees the
    gathered batch already and is left as it is."""
    from ..nn.losses import BatchNorm

    model.data_group = mesh
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm) and not name.startswith("loss."):
            module.data_group = mesh
