"""Q-table persistence and warm starting (paper §3.5 + §5).

The paper ships ``KMP_RL_AGENT_STATS`` (dump Q-value tables after each loop
instance) and suggests the extension: *"This can be extended in the future
and used to initialize the Q-value tables of applications that have already
been executed on a given system.  Thus, eliminating the learning phase of
RL-based methods."*  This module implements exactly that:

* ``AgentStatsLogger`` — per-instance Q-table snapshots (JSON-lines);
* ``save_policy_state`` / ``load_policy_state`` — persist any
  ``SelectionPolicy.state_dict()`` keyed by (region, system fingerprint);
  this is what ``SelectionService(store_dir=...)`` drives automatically;
* ``system_fingerprint`` — a stable digest of the host (the paper keys
  warm starts by application-system *pair*);
* ``save_agent`` / ``load_agent`` / ``warm_start`` — the original
  agent-level helpers, now thin wrappers over
  ``TabularAgent.state_dict()`` / ``load_state_dict()``.
"""

from __future__ import annotations

import json
import os
import platform
import warnings
import zlib
from typing import Dict, Optional

import numpy as np

from .agents import TabularAgent


def _atomic_json_dump(record: Dict, path: str) -> None:
    """Crash-safe JSON write: serialize to a ``.tmp`` sibling, fsync, and
    ``os.replace`` into place — a kill mid-save can truncate only the temp
    file, never a committed snapshot (so a warm-start store survives the
    very crashes it exists to recover from)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _tolerant_json_load(path: str, what: str) -> Optional[Dict]:
    """Load a snapshot, treating a corrupt/unreadable file as a cache miss
    (warn and return None) — a damaged warm-start store must degrade to a
    cold start, never take the run down."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, ValueError, OSError) as e:
        warnings.warn(f"ignoring corrupt {what} snapshot {path!r}: {e}",
                      stacklevel=3)
        return None


def system_fingerprint() -> str:
    """Stable 8-hex digest of the host: the "system" half of the paper's
    application-system pairing.  CRC-32 (not ``hash()``) so the key is
    identical across processes and runs."""
    ident = "|".join((platform.machine(), platform.system(),
                      str(os.cpu_count() or 0)))
    return f"{zlib.crc32(ident.encode('utf-8')):08x}"


class AgentStatsLogger:
    """KMP_RL_AGENT_STATS equivalent: append one Q-table snapshot per loop
    instance to ``<dir>/<region>.jsonl``."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def log(self, region: str, instance: int, agent: TabularAgent) -> None:
        rec = {"instance": instance, "alpha": agent.alpha,
               "state": int(agent.state),
               "learning": bool(agent.learning),
               "q": np.asarray(agent.q).round(6).tolist()}
        with open(os.path.join(self.dir, f"{region}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")


def _key_path(directory: str, region: str, system: str,
              prefix: str = "qtable") -> str:
    safe = f"{region}__{system}".replace("/", "_")
    return os.path.join(directory, f"{prefix}_{safe}.json")


# ---------------------------------------------------------------------------
# policy-level persistence (SelectionService store_dir)
# ---------------------------------------------------------------------------

def save_policy_state(record: Dict, directory: str, region: str,
                      system: str = "default") -> str:
    """Write a ``{"method": ..., "state": policy.state_dict(), ...}`` record
    keyed by (region, system)."""
    os.makedirs(directory, exist_ok=True)
    path = _key_path(directory, region, system, prefix="policy")
    _atomic_json_dump(record, path)
    return path


def load_policy_state(directory: str, region: str,
                      system: str = "default") -> Optional[Dict]:
    path = _key_path(directory, region, system, prefix="policy")
    return _tolerant_json_load(path, "policy")


# ---------------------------------------------------------------------------
# agent-level helpers (pre-redesign surface; still supported)
# ---------------------------------------------------------------------------

def save_agent(agent: TabularAgent, directory: str, region: str,
               system: str = "default") -> str:
    os.makedirs(directory, exist_ok=True)
    path = _key_path(directory, region, system)
    _atomic_json_dump(agent.state_dict(), path)
    return path


def load_agent(directory: str, region: str, system: str = "default"
               ) -> Optional[Dict]:
    path = _key_path(directory, region, system)
    return _tolerant_json_load(path, "agent")


def warm_start(agent: TabularAgent, rec: Dict,
               skip_learning: bool = True) -> TabularAgent:
    """Initialize ``agent`` from a stored record.

    With ``skip_learning`` the agent resumes at the snapshot's instance
    count: a fully-trained record skips the explore-first phase entirely —
    the paper's 28.8 % exploration cost drops to zero on re-runs of a known
    application-system pair — while a record saved *mid-learning* resumes
    exploration where it stopped (it no longer jumps straight to greedy
    exploitation of a half-filled table).  With ``skip_learning=False`` the
    explore-first phase is replayed from scratch over the restored table."""
    agent.load_state_dict(rec, skip_learning=skip_learning)
    return agent
