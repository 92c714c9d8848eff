"""Task models and their assembly from a config."""

from .build import build_main_model, compute_dtype, init_weights, tunable_mask
from .tasks import CLAP, CVAP, MODELS

__all__ = ["CLAP", "CVAP", "MODELS", "build_main_model", "compute_dtype", "init_weights",
           "tunable_mask"]
