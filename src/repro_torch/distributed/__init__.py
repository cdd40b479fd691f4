"""repro_torch.distributed — how a campaign's lanes split over devices,
the step-plan autotuner (the paper's selection at training-step
granularity) and gradient compression."""

from .autotune import (DEFAULT_PLANS, ExecutionPlan, PlanWhatIf,
                       StepAutoTuner, make_plan_builder)
from .compression import EFCompressor, compression_ratio

__all__ = ["ExecutionPlan", "DEFAULT_PLANS", "PlanWhatIf", "StepAutoTuner",
           "make_plan_builder", "EFCompressor", "compression_ratio"]
