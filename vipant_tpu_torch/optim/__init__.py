"""Optimizers: LARS, the schedules, clipping and the trainable/frozen split."""

from .build import Optimizer, build_optimizer, clip_by_global_norm, global_norm
from .lars import LARS, warmup_cosine_lr, warmup_multistep_lr
from .partition import partition_params

__all__ = ["LARS", "Optimizer", "build_optimizer", "clip_by_global_norm", "global_norm",
           "partition_params", "warmup_cosine_lr", "warmup_multistep_lr"]
