"""Training: the train state, the training and eval steps, checkpoints, the
one-device trainer with its epoch loop and the monitors built on it
(``build_monitor`` picks one by ``cfg.monitor``)."""

from .monitors import ASTrainer, ESCTrainer, LATrainer, VALTrainer, VASTrainer
from .state import TrainState
from .step import (apply_gradients, eval_step, loss_and_grads, loss_aux_and_grads, reduce_grads,
                   train_step)
from .trainer import MONITORS, Trainer, build_monitor, register_monitor

__all__ = ["ASTrainer", "ESCTrainer", "LATrainer", "MONITORS", "TrainState", "Trainer",
           "VALTrainer", "VASTrainer",
           "apply_gradients", "build_monitor", "eval_step", "loss_and_grads", "loss_aux_and_grads",
           "reduce_grads", "register_monitor", "train_step"]
