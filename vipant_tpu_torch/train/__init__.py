"""Training: the train state, the step and the one-device trainer."""

from .state import TrainState
from .step import apply_gradients, loss_and_grads, train_step
from .trainer import Trainer

__all__ = ["TrainState", "Trainer", "apply_gradients", "loss_and_grads", "train_step"]
