"""repro_torch.launch — entry points of the port: the trainer
(``launch.train``), the serving launcher (``launch.serve``), the step
builders and shape stand-ins (``launch.steps``), and the dry run
(``python -m repro_torch.launch.dryrun``: every arch x shape step counted
on the meta device by ``launch.cost_analysis``, whose counting mode this
package exports)."""

from .cost_analysis import (BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S,
                            CostCounter, Costs, kernel_cost)

__all__ = ["BF16_OPS_PER_S", "F32_OPS_PER_S", "HBM_BYTES_PER_S",
           "CostCounter", "Costs", "kernel_cost"]
