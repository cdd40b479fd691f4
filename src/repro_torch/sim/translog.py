"""Transition logging for offline policy training.

:class:`TransitionLogger` threads through :class:`~repro_torch.sim.campaign.
ReplayBatch` (``translog=`` on ``ReplayBatch`` / ``run_campaign`` /
``run_selector``): at every lane decision it extracts the decision's
:data:`~repro_torch.core.learned.FEATURE_NAMES` context row and prices **all 12
portfolio algorithms** for that exact (profile, chunk-param, perturbation)
context through the lane system's batched :class:`~repro_torch.sim.whatif.
LoopWhatIf` — so every logged transition carries the full counterfactual
reward vector, not just the chosen arm's outcome.  That makes the dump a
*true contextual-bandit dataset*: the reference's offline trainer
(``repro.runtime.policy_trainer``) reads these shards and can regress
predicted cost per arm directly, with no off-policy importance
correction, regardless of which selector actually drove the lane.

Pricing uses the two-pass what-if (``two_pass=True``): clean steps get
deterministic noise-free costs, perturbed steps get costs under the active
:class:`~repro_torch.sim.backends.base.InstancePerturb` — so drift cells teach
the net what slow PEs and noise bursts do to each algorithm.  Pricing draws
from the what-if's fixed stateless seed and never touches lane rng streams:
a logged replay stays bit-identical to an unlogged one (test-enforced).

Shards are compressed ``.npz`` written atomically (tmp + ``os.replace``,
the ``core.persistence`` discipline), versioned with the feature schema;
``load_shards`` concatenates and schema-checks a shard set.  The shard
format is the reference's, key for key.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import N_ALGORITHMS
from ..core.learned import FEATURE_NAMES, FEATURE_VERSION, LoopFeaturizer
from ..core.simpolicy import Candidate
from .whatif import LoopWhatIf
from .workloads import profile_digest

__all__ = ["TransitionLogger", "TRANSLOG_VERSION", "load_translog",
           "load_shards", "save_translog"]

#: bumped together with the feature schema; a shard's (version,
#: feature_names) pair must match the loader's before training sees it
TRANSLOG_VERSION = 1

_ARRAY_KEYS = ("features", "costs", "libs", "chosen", "measured",
               "cell", "step", "perturbed")


class TransitionLogger:
    """Collects one training transition per (deduplicated) lane decision.

    One logger serves a whole :class:`~repro_torch.sim.campaign.ReplayBatch`; it
    lazily builds one :class:`~repro_torch.core.learned.LoopFeaturizer` and one
    two-pass :class:`~repro_torch.sim.whatif.LoopWhatIf` per machine model.  With
    ``dedupe`` (default), lanes that face the identical decision context —
    same system, loop content, chunk parameter, perturbation and step —
    share one logged row (their features and counterfactual costs are
    identical by construction; only the first lane's chosen arm and live
    outcome are recorded).  ``stride`` keeps every k-th step only.
    """

    def __init__(self, sim_backend=None, stride: int = 1,
                 dedupe: bool = True):
        self.sim_backend = sim_backend
        self.stride = max(1, int(stride))
        self.dedupe = bool(dedupe)
        self._featurizers: Dict[str, LoopFeaturizer] = {}
        self._whatifs: Dict[str, LoopWhatIf] = {}
        self._seen: Dict[tuple, int] = {}
        self._features: List[np.ndarray] = []
        self._costs: List[np.ndarray] = []
        self._libs: List[np.ndarray] = []
        self._chosen: List[int] = []
        self._measured: List[float] = []
        self._cell: List[int] = []
        self._step: List[int] = []
        self._perturbed: List[bool] = []
        self._cell_keys: List[str] = []
        self._cell_index: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._features)

    def _lane_tools(self, lane):
        nm = lane.spec.system
        fz = self._featurizers.get(nm)
        if fz is None:
            fz = self._featurizers[nm] = LoopFeaturizer(lane.system,
                                                        horizon=lane.T)
            self._whatifs[nm] = LoopWhatIf(lane.system,
                                           backend=self.sim_backend,
                                           two_pass=True)
        return fz, self._whatifs[nm]

    def _cell_id(self, lane) -> int:
        key = f"{lane.spec.app}|{lane.spec.system}"
        ci = self._cell_index.get(key)
        if ci is None:
            ci = self._cell_index[key] = len(self._cell_keys)
            self._cell_keys.append(key)
        return ci

    # -- the ReplayBatch hooks ----------------------------------------------
    def log_decision(self, lane, t: int, profile, chunk_param: int,
                     perturb, decision) -> Optional[int]:
        """Record the decision context; returns the row index the lane's
        live outcome should be reported to (``log_result``), or None when
        the row is strided out or deduplicated away."""
        if t % self.stride:
            return None
        pkey = None if perturb is None else perturb.key()
        if self.dedupe:
            key = (lane.spec.system, profile.name, profile_digest(profile),
                   profile.unit, chunk_param, pkey, t, lane.T)
            if key in self._seen:
                return None
            self._seen[key] = len(self._features)
        fz, wi = self._lane_tools(lane)
        fz.set_context(profile, chunk_param, perturb=perturb)
        wi.set_context(profile, chunk_param, perturb=perturb)
        obs = wi.price([Candidate(a) for a in range(N_ALGORITHMS)])
        self._features.append(fz.features(phase=t / lane.T))
        self._costs.append(np.array([o.loop_time for o in obs], np.float32))
        self._libs.append(np.array([o.lib for o in obs], np.float32))
        self._chosen.append(int(decision.action))
        self._measured.append(-1.0)     # filled by log_result
        self._cell.append(self._cell_id(lane))
        self._step.append(int(t))
        self._perturbed.append(pkey is not None)
        return len(self._features) - 1

    def log_result(self, index: int, loop_time: float) -> None:
        """Attach the chosen arm's live outcome to a logged row."""
        self._measured[index] = float(loop_time)

    # -- export --------------------------------------------------------------
    def arrays(self) -> Dict[str, np.ndarray]:
        """The shard payload (see ``save_translog`` for the schema)."""
        n = len(self._features)
        return {
            "version": np.int64(TRANSLOG_VERSION),
            "feature_names": np.array(FEATURE_NAMES),
            "feature_version": np.int64(FEATURE_VERSION),
            "features": (np.stack(self._features) if n
                         else np.zeros((0, len(FEATURE_NAMES)), np.float32)),
            "costs": (np.stack(self._costs) if n
                      else np.zeros((0, N_ALGORITHMS), np.float32)),
            "libs": (np.stack(self._libs) if n
                     else np.zeros((0, N_ALGORITHMS), np.float32)),
            "chosen": np.asarray(self._chosen, np.int16),
            "measured": np.asarray(self._measured, np.float32),
            "cell": np.asarray(self._cell, np.int32),
            "step": np.asarray(self._step, np.int32),
            "perturbed": np.asarray(self._perturbed, np.bool_),
            "cell_keys": np.array(self._cell_keys or [""]),
        }

    def save(self, path: str) -> str:
        """Atomically write the collected transitions as one npz shard."""
        return save_translog(path, self.arrays())


def save_translog(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Atomic compressed-npz write: tmp file + ``os.replace``, so a killed
    ``gen_translog`` run never leaves a torn shard for training to read."""
    path = str(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _check_schema(d: Dict[str, np.ndarray], path: str) -> None:
    ver = int(d.get("version", -1))
    if ver != TRANSLOG_VERSION:
        raise ValueError(f"{path}: translog version {ver}, expected "
                         f"{TRANSLOG_VERSION}")
    names = tuple(str(s) for s in d["feature_names"])
    if names != FEATURE_NAMES:
        raise ValueError(f"{path}: feature schema mismatch "
                         f"({names} != {FEATURE_NAMES})")


def load_translog(path: str) -> Dict[str, np.ndarray]:
    """Load one shard, schema-checked against this build's features."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    _check_schema(d, path)
    return d


def load_shards(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """Concatenate many shards into one training dict.  Per-shard ``cell``
    indices are rebased onto a merged ``cell_keys`` table, so the
    (app, system) held-out split works across shard boundaries."""
    if not paths:
        raise ValueError("no translog shards given")
    merged_keys: List[str] = []
    key_index: Dict[str, int] = {}
    parts: Dict[str, List[np.ndarray]] = {k: [] for k in _ARRAY_KEYS}
    for path in paths:
        d = load_translog(path)
        for k in d["cell_keys"]:
            key_index.setdefault(str(k), len(key_index))
        remap = np.array([key_index[str(k)] for k in d["cell_keys"]],
                         np.int32)
        for k in _ARRAY_KEYS:
            arr = d[k]
            if k == "cell" and len(arr):
                arr = remap[arr]
            parts[k].append(arr)
    merged_keys = [k for k, _ in sorted(key_index.items(),
                                        key=lambda kv: kv[1])]
    out = {k: np.concatenate(v) if v else np.zeros(0) for k, v in
           parts.items()}
    out["cell_keys"] = np.array(merged_keys)
    out["feature_names"] = np.array(FEATURE_NAMES)
    out["version"] = np.int64(TRANSLOG_VERSION)
    return out
