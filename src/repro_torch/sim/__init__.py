"""repro_torch.sim — the batched discrete-event simulator of the paper's
portfolio sweep, on the card."""

from .backends import (EVENT_CAP, BatchResult, InstancePerturb, InstanceSpec,
                       LockstepRequest, SimBackend, backend_names,
                       get_backend, register_backend)
from .campaign import (CHUNK_MODES, FixedRun, PortfolioSweep,
                       chunk_param_for, run_fixed, sweep_portfolio)
from .systems import (HETERO_SYSTEMS, SYSTEMS, SystemModel, get_system,
                      hetero_system)
from .workloads import (APPLICATIONS, GRID, Application, LoopProfile,
                        ProfileStack, get_application, profile_digest,
                        stack_prefix_grids)

__all__ = [
    "EVENT_CAP", "BatchResult", "InstancePerturb", "InstanceSpec",
    "LockstepRequest", "SimBackend", "backend_names", "get_backend",
    "register_backend", "CHUNK_MODES", "FixedRun", "PortfolioSweep",
    "chunk_param_for", "run_fixed", "sweep_portfolio", "HETERO_SYSTEMS",
    "SYSTEMS", "SystemModel", "get_system", "hetero_system", "APPLICATIONS",
    "GRID", "Application", "LoopProfile", "ProfileStack", "get_application",
    "profile_digest", "stack_prefix_grids",
]
