"""repro_torch.runtime — the training runtime: the learned-selection policy
trainer and its checkpoint/restart discipline."""

from .trainer import SimulatedFailure
from .policy_trainer import (PolicyTrainer, PolicyTrainerConfig,
                             TransitionDataset, train_policy_state)

__all__ = ["SimulatedFailure", "PolicyTrainer", "PolicyTrainerConfig",
           "TransitionDataset", "train_policy_state"]
