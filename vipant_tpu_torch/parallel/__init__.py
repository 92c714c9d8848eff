"""Data parallelism over ``torch.distributed``: the mesh's ``data`` axis, its
collectives, ZeRO-1 and the gradient cache (``vipant_tpu/parallel``'s data
axis; the ``model``, ``pipe`` and ``seq`` axes are ROADMAP.md queue A,
A15-rest)."""

from .collectives import all_reduce_grads, all_reduce_sum, broadcast_, gather_batch
from .grad_cache import chunk_count, grad_cache_value_and_grad
from .mesh import (Mesh, attach, data_shard_info, distributed_init, launcher_device, launcher_env,
                   make_mesh, replicate, shard_batch)
from .zero import ZeroOptimizer, assign_owners

__all__ = ["Mesh", "ZeroOptimizer", "all_reduce_grads", "all_reduce_sum", "assign_owners", "attach",
           "broadcast_", "chunk_count", "data_shard_info", "distributed_init", "gather_batch",
           "grad_cache_value_and_grad", "launcher_device", "launcher_env", "make_mesh", "replicate",
           "shard_batch"]
