"""repro_torch.runtime — the training runtime: the model trainer and the
learned-selection policy trainer, with their checkpoint/restart
discipline."""

from .trainer import SimulatedFailure, Trainer, TrainerConfig
from .policy_trainer import (PolicyTrainer, PolicyTrainerConfig,
                             TransitionDataset, train_policy_state)

__all__ = ["Trainer", "TrainerConfig", "SimulatedFailure", "PolicyTrainer",
           "PolicyTrainerConfig", "TransitionDataset", "train_policy_state"]
