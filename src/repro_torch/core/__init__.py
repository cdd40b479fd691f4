"""repro_torch.core — the scheduling portfolio, its chunk schedules and the
load-imbalance metrics."""

from .metrics import (coefficient_of_variation, execution_imbalance,
                      percent_load_imbalance)
from .portfolio import (ADAPTIVE_SET, ALGORITHM_NAMES, DIRECT_CHUNK_SET,
                        N_ALGORITHMS, apply_chunk_floor, exp_chunk)
from .sched import SCHEDULABLE, chunk_schedule, staticsteal_schedule

__all__ = [
    "coefficient_of_variation", "execution_imbalance",
    "percent_load_imbalance", "ADAPTIVE_SET", "ALGORITHM_NAMES",
    "DIRECT_CHUNK_SET", "N_ALGORITHMS", "apply_chunk_floor", "exp_chunk",
    "SCHEDULABLE", "chunk_schedule", "staticsteal_schedule",
]
