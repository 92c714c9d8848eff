"""The mesh's four axes over ``torch.distributed``: ``data`` (collectives,
ZeRO-1, the gradient cache), ``model`` (:mod:`.tensor`), ``pipe``
(:mod:`.pipeline`) and ``seq`` (:mod:`.sequence`); the counterpart of
``vipant_tpu/parallel``."""

from .collectives import all_reduce_grads, all_reduce_sum, broadcast_, gather_batch
from .grad_cache import chunk_count, grad_cache_value_and_grad
from .mesh import (Mesh, attach, data_shard_info, distributed_init, launcher_device, launcher_env,
                   make_mesh, replicate, shard_batch)
from .tensor import Placement, shard_model
from .zero import ZeroOptimizer, assign_owners

__all__ = ["Mesh", "Placement", "ZeroOptimizer", "all_reduce_grads", "all_reduce_sum",
           "assign_owners", "attach", "broadcast_", "chunk_count", "data_shard_info",
           "distributed_init", "gather_batch", "grad_cache_value_and_grad", "launcher_device",
           "launcher_env", "make_mesh", "replicate", "shard_batch", "shard_model"]
