"""repro_torch.serving — the dispatch simulator (the paper's technique at
dispatch granularity), continuous batching with the replica cost model,
and the fleet: trace-driven routing over replica groups with faults,
recovery and a crash-safe journal."""

from .engine import (ContinuousBatcher, DispatchSimulator, ReplicaCostModel,
                     WaveStats, WaveWhatIf)
from .fleet import (AdmissionControl, ArrivalTrace, FleetReport,
                    FleetSimulator, FleetView, LeastOutstandingRouter,
                    RecoveryLedger, RecoveryPolicy, RoundRobinRouter,
                    RouterPolicy, RunJournal, WhatIfRouter, make_router,
                    make_trace)

__all__ = [
    "ContinuousBatcher", "DispatchSimulator", "ReplicaCostModel",
    "WaveStats", "WaveWhatIf", "AdmissionControl", "ArrivalTrace",
    "FleetReport", "FleetSimulator", "FleetView", "LeastOutstandingRouter",
    "RecoveryLedger", "RecoveryPolicy", "RoundRobinRouter", "RouterPolicy",
    "RunJournal", "WhatIfRouter", "make_router", "make_trace",
]
