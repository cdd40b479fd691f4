"""repro_torch.sim — the discrete-event simulator of the paper's experiment
campaign: the batched engine on the card (the portfolio sweep, the lockstep
selector replays, candidate pricing for simulation-assisted selection and
transition logging), the reference Python event loop on the host, and the
perturbations and heterogeneous machines that make a cell non-stationary,
and the fleet perturbations of the serving layer."""

from .backends import (EVENT_CAP, BatchResult, InstancePerturb, InstanceSpec,
                       LockstepRequest, SimBackend, backend_names,
                       get_backend, register_backend)
from .engine import InstanceResult, run_instance
from .perturb import (FleetPerturb, GroupSlowdown, NoiseBurst, PEFailure,
                      PESlowdown, PerturbationSpec, ReplicaFailure,
                      ReplicaStraggler, WorkloadDrift, drift_spec,
                      noise_burst_spec, pe_slowdown_spec)
from .campaign import (CHUNK_MODES, EXTENDED_SELECTOR_GRID, SELECTOR_GRID,
                       SIM_SELECTOR_GRID, CampaignResult, CellSpec, FixedRun,
                       PortfolioSweep, ReplayBatch, SelectorRun,
                       chunk_param_for, run_campaign, run_campaign_cell,
                       run_fixed, run_selector, run_selector_sequential,
                       sweep_portfolio)
from .systems import (HETERO_SYSTEMS, SYSTEMS, SystemModel, get_system,
                      hetero_system)
from .translog import (TRANSLOG_VERSION, TransitionLogger, load_shards,
                       load_translog, save_translog)
from .whatif import LoopWhatIf, noise_free
from .workloads import (APPLICATIONS, GRID, Application, LoopProfile,
                        ProfileStack, get_application, profile_digest,
                        stack_prefix_grids)

__all__ = [
    "EVENT_CAP", "BatchResult", "InstancePerturb", "InstanceSpec",
    "LockstepRequest", "SimBackend", "backend_names", "get_backend",
    "register_backend", "InstanceResult", "run_instance",
    "PerturbationSpec", "PESlowdown", "PEFailure", "NoiseBurst",
    "WorkloadDrift", "pe_slowdown_spec", "noise_burst_spec", "drift_spec",
    "FleetPerturb", "GroupSlowdown", "ReplicaFailure", "ReplicaStraggler",
    "CHUNK_MODES", "SELECTOR_GRID",
    "EXTENDED_SELECTOR_GRID", "SIM_SELECTOR_GRID", "CampaignResult",
    "CellSpec", "FixedRun", "PortfolioSweep", "ReplayBatch", "SelectorRun",
    "chunk_param_for", "run_campaign", "run_campaign_cell", "run_fixed",
    "run_selector", "run_selector_sequential", "sweep_portfolio",
    "HETERO_SYSTEMS", "SYSTEMS", "SystemModel", "get_system",
    "hetero_system", "TRANSLOG_VERSION", "TransitionLogger", "load_shards",
    "load_translog", "save_translog", "LoopWhatIf", "noise_free",
    "APPLICATIONS", "GRID", "Application", "LoopProfile", "ProfileStack",
    "get_application", "profile_digest", "stack_prefix_grids",
]
