"""Crash-safe wave-granularity journaling for ``FleetSimulator.run`` — the
port's copy of ``repro.serving.fleet.journal``, in the same format (the
``.npz`` bundles, their names and ``_VERSION``), so a journal written by
either package resumes in the other.

A :class:`RunJournal` persists one atomic snapshot of the full fleet run
state per wave (or every ``every`` waves): fleet clock, trace cursor,
per-group replica finish times and busy accounting, the pending/retry
queues and attempt ledger, committed latency segments, per-group wave
stats, router state, and each region policy's ``state_dict``.  A
fleet run of any size killed at ANY point resumes from
its newest snapshot and finishes **bit-identically** to an uninterrupted
run — the run loop is deterministic given the snapshot, retry jitter is
stateless, so replaying the remaining waves reproduces every latency,
counter, and report field exactly (test-enforced).

Atomicity: each snapshot is serialized to a
``.tmp`` sibling and ``os.replace``d into place — a crash mid-write can
truncate only the temp file, never a committed snapshot.  ``latest()``
additionally skips unreadable snapshots (defense against torn filesystems)
with a warning instead of refusing to resume.

Snapshots are ``.npz`` bundles: numpy arrays for the bulky state (latency
segments, queues, replica matrices) plus one JSON-encoded ``meta`` array
for scalars and nested records.  Retention keeps the newest ``keep``
snapshots (``keep=0`` keeps everything — tests resume from arbitrary
waves that way).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RunJournal"]

_PREFIX = "wave_"
_VERSION = 1


class RunJournal:
    """Atomic per-wave snapshots of one fleet run under ``directory``."""

    def __init__(self, directory: str, every: int = 1, keep: int = 2):
        if every < 1:
            raise ValueError("journal cadence `every` must be >= 1")
        self.dir = directory
        self.every = int(every)
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, wave: int, meta: Dict, arrays: Dict[str, np.ndarray]
             ) -> str:
        """Atomically write snapshot ``wave``: ``meta`` is JSON-able scalar
        /nested state, ``arrays`` the numpy bulk."""
        meta = dict(meta)
        meta["version"] = _VERSION
        meta["wave"] = int(wave)
        final = os.path.join(self.dir, f"{_PREFIX}{wave:09d}.npz")
        tmp = final + ".tmp"
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        payload["meta"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)          # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for w in self.waves()[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"{_PREFIX}{w:09d}.npz"))
            except OSError:
                pass

    # -- restore -------------------------------------------------------------
    def waves(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            if name.startswith(_PREFIX) and name.endswith(".npz"):
                try:
                    out.append(int(name[len(_PREFIX):-4]))
                except ValueError:
                    continue
        return sorted(out)

    def load(self, wave: int) -> Dict:
        """Load snapshot ``wave`` into ``{"meta": dict, <array fields>}``."""
        path = os.path.join(self.dir, f"{_PREFIX}{wave:09d}.npz")
        with np.load(path) as z:
            out = {k: z[k] for k in z.files if k != "meta"}
            meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        if meta.get("version") != _VERSION:
            raise ValueError(f"journal snapshot {path} has version "
                             f"{meta.get('version')}, expected {_VERSION}")
        out["meta"] = meta
        return out

    def latest(self) -> Optional[Dict]:
        """Newest loadable snapshot (corrupt ones are skipped with a
        warning), or ``None`` when the journal is empty."""
        for w in reversed(self.waves()):
            try:
                return self.load(w)
            except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
                warnings.warn(f"skipping unreadable journal snapshot "
                              f"wave {w}: {e}", stacklevel=2)
        return None

    def clear(self) -> None:
        """Drop every snapshot (a completed run's journal is spent)."""
        for w in self.waves():
            try:
                os.remove(os.path.join(self.dir, f"{_PREFIX}{w:09d}.npz"))
            except OSError:
                pass
