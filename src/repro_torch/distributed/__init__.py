"""repro_torch.distributed — how a campaign's lanes split over devices,
the model stack's sharding specs on the production layouts, the step-plan
autotuner (the paper's selection at training-step granularity) and
gradient compression."""

from .autotune import (DEFAULT_PLANS, ExecutionPlan, PlanWhatIf,
                       StepAutoTuner, make_plan_builder)
from .compression import EFCompressor, compression_ratio
from .sharding import (batch_specs, cache_specs, data_axes, fit_spec, named,
                       opt_specs, param_specs)

__all__ = ["ExecutionPlan", "DEFAULT_PLANS", "PlanWhatIf", "StepAutoTuner",
           "make_plan_builder", "EFCompressor", "compression_ratio",
           "param_specs", "batch_specs", "cache_specs", "opt_specs", "named",
           "data_axes", "fit_spec"]
