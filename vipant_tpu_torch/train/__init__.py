"""Training: the train state, the training and eval steps, checkpoints and
the one-device trainer with its epoch loop."""

from .state import TrainState
from .step import apply_gradients, eval_step, loss_and_grads, train_step
from .trainer import Trainer, build_monitor

__all__ = ["TrainState", "Trainer", "apply_gradients", "build_monitor", "eval_step",
           "loss_and_grads", "train_step"]
