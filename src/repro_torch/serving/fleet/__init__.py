"""Fleet-scale serving: trace-driven routing over continuous-batching
replica groups (see ``simulator``/``router``/``traces``), with fault
injection, recovery, and crash-safe journaled resume (``recovery``/
``journal``) — the port of ``repro.serving.fleet``."""

from .journal import RunJournal
from .recovery import (BASELINE_RECOVERY, RecoveryLedger, RecoveryPolicy,
                       RetryEntry)
from .router import (ROUTERS, LeastOutstandingRouter, RoundRobinRouter,
                     RouterPolicy, WhatIfRouter, make_router)
from .simulator import (AdmissionControl, FleetReport, FleetSimulator,
                        FleetView)
from .traces import (TRACE_KINDS, ArrivalTrace, bursty_trace, diurnal_trace,
                     make_trace, poisson_trace)

__all__ = [
    "ArrivalTrace", "TRACE_KINDS", "make_trace", "poisson_trace",
    "bursty_trace", "diurnal_trace",
    "RouterPolicy", "RoundRobinRouter", "LeastOutstandingRouter",
    "WhatIfRouter", "ROUTERS", "make_router",
    "FleetSimulator", "FleetView", "FleetReport", "AdmissionControl",
    "RecoveryPolicy", "RecoveryLedger", "RetryEntry", "BASELINE_RECOVERY",
    "RunJournal",
]
