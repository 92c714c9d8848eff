"""Task models and their assembly from a config."""

from .build import (build_main_model, compute_dtype, init_weights, port_model_from_clip,
                    siamese_ties, tie_model, tunable_mask)
from .tasks import CLAP, CLVP, CVALP, CVAP, CVASP, MODELS

__all__ = ["CLAP", "CLVP", "CVALP", "CVAP", "CVASP", "MODELS", "build_main_model", "compute_dtype",
           "init_weights", "port_model_from_clip", "siamese_ties", "tie_model", "tunable_mask"]
