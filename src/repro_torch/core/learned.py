"""Learned selection, the inference half: an offline-trained
contextual-bandit policy.

A small MLP maps structured context *features* (loop profile shape, machine
model, heterogeneity/perturbation telemetry, step phase) to a predicted cost
per portfolio algorithm.  It is trained offline by
``repro_torch.runtime.policy_trainer`` on lockstep-replay transition logs
(``repro_torch.sim.translog`` — every transition carries all 12
counterfactual prices, so this is a true bandit dataset and no off-policy
correction is needed).

Three consumers of the trained net:

``LearnedPolicy``
    A :class:`~repro_torch.core.api.SelectionPolicy` whose ``decide()`` is
    one numpy MLP forward (microseconds — no per-decision what-if call like
    SimPolicy).  Needs a :class:`LoopFeaturizer` bound to the lane's machine
    model; the campaign wiring re-binds the current loop with
    ``set_context`` exactly like a SimPolicy lane's ``LoopWhatIf``.  Without
    weights or context it degrades to the expert fuzzy ladder.

``LearnedHybrid``
    :class:`~repro_torch.core.selectors.HybridPolicy` whose RL exploration
    window is pre-pruned to the net's predicted top-k — the learned twin of
    ``SimAssistedHybrid``, without the per-build pricing call.

``distill_ladder``
    Extracts an interpretable threshold ladder (a depth-bounded decision
    tree over the named features) from the trained net, held within a
    bounded regret of its teacher on held-out cells (``chip_smoke.py``
    phase [16]).

Weights travel as JSON-serializable state dicts (``state_dict`` /
``load_state_dict``), so ``SelectionService(store_dir=...)`` warm starting
works unchanged.  ``REPRO_LEARNED_STATE`` may name a state JSON on disk to
give every ``make_policy("Learned")`` call a default set of weights.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .portfolio import N_ALGORITHMS
from .rewards import REWARD_POSITIVE
from .selectors import ExpertPolicy, HybridPolicy
from .api import Decision, Observation, SelectionPolicy, get_reward
from .simpolicy import SimUnavailable

__all__ = [
    "FEATURE_NAMES", "N_FEATURES", "FEATURE_VERSION", "LEARNED_STATE_ENV",
    "LoopFeaturizer", "LearnedPolicy", "LearnedHybrid",
    "mlp_forward", "params_from_state", "params_to_state",
    "make_learned_state", "set_default_state", "resolve_default_state",
    "is_learned_policy", "LEARNED_POLICY_NAMES",
    "DistilledLadder", "distill_ladder",
]

#: env var naming a LearnedPolicy state JSON on disk — the default weights
#: for every ``make_policy("Learned")`` call that passes none explicitly
LEARNED_STATE_ENV = "REPRO_LEARNED_STATE"

#: bump when the feature extraction changes incompatibly; stored states
#: carry it and a mismatch is a warm-start miss, never a silent mis-read
FEATURE_VERSION = 1

#: canonical registry spellings (``make_policy`` accepts these, lowercased)
LEARNED_POLICY_NAMES = ["Learned", "LearnedHybrid"]

_LEARNED_ALIASES = {
    "learned": "Learned", "learnedpolicy": "Learned",
    "learnedsel": "Learned", "mlp": "Learned",
    "learnedhybrid": "LearnedHybrid", "learned-hybrid": "LearnedHybrid",
    "learnedrl": "LearnedHybrid",
}

FEATURE_NAMES: Tuple[str, ...] = (
    # -- loop profile -------------------------------------------------------
    "log_n",          # log10 iteration count
    "log_total",      # log10 total work (s)
    "cov",            # c.o.v. of the per-bucket cost density (imbalance)
    "head_share",     # cost share of the costliest 5 % of buckets
    "memory_bound",
    "locality_sens",
    "log_c_loc",      # log2 reuse window
    # -- machine model ------------------------------------------------------
    "log_p",          # log2 PE count
    "log_h",          # log10 dispatch overhead
    "h_adaptive_mult",
    "h_serial_frac",
    "log_boundary",   # log10 per-chunk boundary cost
    "dyn_locality",
    "loc_amp",
    "noise_sigma",
    "log_jitter",
    "speed_spread",
    # -- heterogeneity + perturbation telemetry -----------------------------
    "pe_cov",         # c.o.v. of the effective per-PE speed multipliers
    "pe_max_ratio",   # log2(max/min) effective multiplier (capped)
    "pe_fail_frac",   # fraction of effectively dead PEs
    "log_sigma_scale",  # log2 of the perturbation's noise-sigma scale
    # -- decision context ---------------------------------------------------
    "chunk_norm",     # chunk_param * P / N (0 = default chunking)
    "phase",          # t / horizon, clipped to [0, 1]
)

N_FEATURES = len(FEATURE_NAMES)

_FEATURIZER_CACHE = 512      # per-profile feature rows kept (LRU)

#: an effective multiplier this large means "dead PE" for telemetry purposes
_FAIL_THRESHOLD = 100.0


def _log10(x: float) -> float:
    return math.log10(max(float(x), 1e-12))


def _density_stats(profile) -> Tuple[float, float]:
    """(cov, head_share) of the profile's per-bucket cost density."""
    grid = getattr(profile, "prefix_grid", None)
    if grid is None:
        return 0.0, 0.05        # uniform: head share is its 5 % baseline
    dens = np.maximum(np.diff(np.asarray(grid, np.float64)), 0.0)
    mean = float(dens.mean())
    if mean <= 0.0:
        return 0.0, 0.05
    cov = float(dens.std() / mean)
    k = max(1, len(dens) // 20)
    head = float(np.sort(dens)[-k:].sum() / max(dens.sum(), 1e-300))
    return cov, head


def _pe_telemetry(system, perturb) -> Tuple[float, float, float]:
    """(pe_cov, pe_max_ratio, pe_fail_frac) of the *effective* per-PE speed
    multipliers: persistent ``pe_speeds`` heterogeneity composed with any
    instance perturbation.  Computed locally (no backend import) so the
    featurizer stays dependency-free."""
    speeds = getattr(system, "pe_speeds", None)
    scale = None if speeds is None else np.asarray(speeds, np.float64)
    pscale = None if perturb is None else getattr(perturb, "pe_scale", None)
    if pscale is not None:
        ps = np.asarray(pscale, np.float64)
        scale = ps if scale is None else scale * ps
    if scale is None:
        return 0.0, 0.0, 0.0
    mean = float(scale.mean())
    cov = float(scale.std() / mean) if mean > 0 else 0.0
    ratio = float(scale.max() / max(scale.min(), 1e-12))
    fail = float((scale >= _FAIL_THRESHOLD).mean())
    return cov, min(math.log2(max(ratio, 1.0)), 16.0), fail


class LoopFeaturizer:
    """Context features for one campaign lane.

    Mirrors the :class:`~repro_torch.sim.whatif.LoopWhatIf` surface the campaign
    already drives — ``set_context(profile, chunk_param, perturb)`` before
    each decision — so learned lanes slot into ``ReplayBatch`` through the
    exact call site sim-assisted lanes use.  ``features(phase)`` returns the
    (N_FEATURES,) float32 row for the bound context; no context bound raises
    :class:`~repro_torch.core.simpolicy.SimUnavailable` (the policy then falls
    back to its expert ladder, like a SimPolicy without a pricer).
    """

    def __init__(self, system, horizon: int = 500):
        self.system = system
        self.horizon = max(1, int(horizon))
        self._profile = None
        self._chunk_param = 0
        self._perturb = None
        # system features never change for a lane: precompute once
        self._sys = np.array([
            math.log2(max(system.P, 1)),
            _log10(system.h),
            float(system.h_adaptive_mult),
            float(system.h_serial_frac),
            _log10(system.boundary_cost),
            float(system.dyn_locality),
            float(system.loc_amp),
            float(system.noise_sigma),
            _log10(system.jitter),
            float(system.speed_spread),
        ], dtype=np.float32)
        self._profile_cache: "Dict[tuple, np.ndarray]" = {}

    # -- the LoopWhatIf-shaped context surface ------------------------------
    def set_context(self, profile, chunk_param: int = 0,
                    perturb=None) -> None:
        """Bind the loop instance the next ``features`` calls are about."""
        self._profile = profile
        self._chunk_param = int(chunk_param)
        self._perturb = None if (perturb is not None
                                 and perturb.neutral) else perturb

    def _profile_row(self, p) -> np.ndarray:
        from ..sim.workloads import profile_digest
        key = profile_digest(p)
        row = self._profile_cache.get(key)
        if row is None:
            cov, head = _density_stats(p)
            row = np.array([
                _log10(p.N), _log10(p.total), cov, head,
                float(p.memory_bound), float(p.locality_sens),
                math.log2(max(p.c_loc, 1)),
            ], dtype=np.float32)
            if len(self._profile_cache) >= _FEATURIZER_CACHE:
                self._profile_cache.clear()     # cheap to refill
            self._profile_cache[key] = row
        return row

    def features(self, phase: float = 0.0) -> np.ndarray:
        """(N_FEATURES,) float32 feature row for the bound context."""
        if self._profile is None:
            raise SimUnavailable("LoopFeaturizer has no loop context bound")
        p = self._profile
        pe_cov, pe_ratio, pe_fail = _pe_telemetry(self.system, self._perturb)
        ss = 1.0 if self._perturb is None else float(
            getattr(self._perturb, "sigma_scale", 1.0))
        ctx = np.array([
            pe_cov, pe_ratio, pe_fail, math.log2(max(ss, 1e-6)),
            self._chunk_param * self.system.P / max(p.N, 1),
            min(max(float(phase), 0.0), 1.0),
        ], dtype=np.float32)
        return np.concatenate([self._profile_row(p), self._sys, ctx])


# ---------------------------------------------------------------------------
# numpy MLP forward (the deployed inference path)
# ---------------------------------------------------------------------------

def _gelu(x: np.ndarray) -> np.ndarray:
    """tanh-approximated GELU, the approximation the trainer's GELU uses,
    so the deployed numpy forward matches training."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))


def mlp_forward(params: Dict[str, np.ndarray], x: np.ndarray) -> np.ndarray:
    """Predicted per-algorithm normalized log-cost.  ``x`` is (F,) or
    (B, F); returns (A,) / (B, A).  Architecture matches the trainer's
    forward (``repro.runtime.policy_trainer``): feature layer + one GELU
    MLP block."""
    h0 = _gelu(x @ params["w0"] + params["b0"])
    h1 = _gelu(h0 @ params["w1"] + params["b1"])
    return h1 @ params["w2"] + params["b2"]


def params_to_state(params: Dict[str, np.ndarray]) -> Dict[str, list]:
    return {k: np.asarray(v, np.float32).tolist() for k, v in params.items()}


def params_from_state(state: Dict[str, list]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _validate_params(params: Dict[str, np.ndarray], n_actions: int) -> None:
    for k in ("w0", "b0", "w1", "b1", "w2", "b2"):
        if k not in params:
            raise ValueError(f"learned state is missing array {k!r}")
    if params["w0"].shape[0] != N_FEATURES:
        raise ValueError(
            f"learned state expects {params['w0'].shape[0]} features, this "
            f"build extracts {N_FEATURES} (feature version skew)")
    if params["w2"].shape[1] != n_actions:
        raise ValueError(
            f"learned state predicts {params['w2'].shape[1]} actions, "
            f"portfolio has {n_actions}")


def make_learned_state(params: Dict[str, np.ndarray], reward: str = "LT",
                       meta: Optional[dict] = None) -> dict:
    """The JSON-serializable record ``LearnedPolicy.load_state_dict``
    accepts (and ``state_dict`` emits) — also what ``policy_trainer``
    exports and ``REPRO_LEARNED_STATE`` files contain."""
    return {"kind": "Learned", "reward": reward,
            "feature_version": FEATURE_VERSION,
            "feature_names": list(FEATURE_NAMES),
            "params": params_to_state(params),
            "meta": dict(meta or {})}


_DEFAULT_STATE: Optional[dict] = None


def set_default_state(state: Optional[dict]) -> None:
    """Process-wide default weights for policies built without explicit
    ``state=`` (e.g. campaign lanes spawned by name).  ``None`` clears."""
    global _DEFAULT_STATE
    _DEFAULT_STATE = state


def resolve_default_state() -> Optional[dict]:
    """Explicit ``set_default_state`` wins; else a ``REPRO_LEARNED_STATE``
    JSON path is loaded tolerantly (a corrupt/missing file degrades to a
    cold policy, never takes the run down)."""
    if _DEFAULT_STATE is not None:
        return _DEFAULT_STATE
    path = os.environ.get(LEARNED_STATE_ENV)
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        warnings.warn(f"ignoring unreadable {LEARNED_STATE_ENV}={path!r}: "
                      f"{e}", stacklevel=2)
        return None


def is_learned_policy(name: Optional[str]) -> bool:
    """True when ``name`` spells one of the learned methods."""
    return isinstance(name, str) and name.lower() in _LEARNED_ALIASES


# ---------------------------------------------------------------------------
# LearnedPolicy — one numpy forward per decision
# ---------------------------------------------------------------------------

class LearnedPolicy(SelectionPolicy):
    """Contextual-bandit selection: argmin of the net's predicted per-
    algorithm cost for the current context.

    Zero live exploration and zero per-decision simulation: where SimPolicy
    prices 12+ candidates through a what-if ``run_batch`` every decision,
    this is one (F,)x(F,H) matmul chain.  The embedded expert ladder digests
    every live observation, so the *fallback* (no weights, or no context
    bound) stays anchored to the live (LT, LIB) trajectory."""

    name = "Learned"

    def __init__(self, featurizer: Optional[LoopFeaturizer] = None,
                 state: Optional[dict] = None, reward="LT",
                 n_actions: int = N_ALGORITHMS, horizon: int = 500):
        self.featurizer = featurizer
        self.reward_name = reward if isinstance(reward, str) else getattr(
            reward, "__name__", "custom")
        self._reward_fn = get_reward(reward)
        self.n_actions = int(n_actions)
        self.horizon = max(1, int(horizon))
        self._fallback = ExpertPolicy(n_actions=n_actions)
        self._params: Optional[Dict[str, np.ndarray]] = None
        self._meta: dict = {}
        self._t = 0
        if state is None:
            state = resolve_default_state()
        if state is not None:
            self.load_state_dict(state)

    @property
    def trained(self) -> bool:
        return self._params is not None

    @property
    def learning_steps(self) -> int:
        return 0 if self.trained else self._fallback.learning_steps

    @property
    def learning(self) -> bool:
        return False if self.trained else self._fallback.learning

    def scores(self, phase: Optional[float] = None) -> Optional[np.ndarray]:
        """(n_actions,) predicted normalized log-costs for the featurizer's
        bound context, or None when the net cannot score (cold / no
        context)."""
        if self._params is None or self.featurizer is None:
            return None
        try:
            x = self.featurizer.features(
                phase=(self._t / self.horizon) if phase is None else phase)
        except SimUnavailable:
            return None
        return np.asarray(mlp_forward(self._params, x), np.float64)

    def decide(self) -> Decision:
        s = self.scores()
        if s is None:
            d = self._fallback.decide()
            return Decision(action=d.action, phase="expert",
                            confidence=d.confidence)
        best = int(np.argmin(s))
        second = float(np.partition(s, 1)[1]) if len(s) > 1 else float(s[best])
        spread = float(s.max() - s.min())
        conf = 0.0 if spread <= 0 else float(
            np.clip((second - float(s[best])) / spread, 0.0, 1.0))
        return Decision(action=best, phase="exploit", confidence=conf)

    def feedback(self, decision: Decision, obs: Observation) -> None:
        self._fallback.feedback(decision, obs)
        self._t += 1

    # -- persistence (SelectionService store_dir warm start) ----------------
    def state_dict(self) -> Optional[dict]:
        if self._params is None:
            return None
        return make_learned_state(self._params, reward=self.reward_name,
                                  meta=self._meta)

    def load_state_dict(self, state: dict, *,
                        skip_learning: bool = True) -> bool:
        ver = int(state.get("feature_version", -1))
        if ver != FEATURE_VERSION:
            raise ValueError(
                f"learned state has feature_version {ver}, this build "
                f"extracts version {FEATURE_VERSION}")
        params = params_from_state(state["params"])
        _validate_params(params, self.n_actions)
        self._params = params
        self._meta = dict(state.get("meta") or {})
        return True


# ---------------------------------------------------------------------------
# LearnedHybrid — the net seeds/bounds the RL window
# ---------------------------------------------------------------------------

class LearnedHybrid(HybridPolicy):
    """Hybrid expert+RL whose exploration window is pruned by the *net's*
    predicted cost — exactly how ``SimAssistedHybrid`` prunes by simulated
    cost, minus the per-build what-if call.  The RL agent then verifies the
    net's neighbourhood on live traffic (``expert_steps + top_k**2``
    instances) and can overrule a mis-ranked winner; without weights or
    context, the expert-ladder window of :class:`HybridPolicy` applies
    unchanged."""

    name = "LearnedHybrid"

    def __init__(self, featurizer: Optional[LoopFeaturizer] = None,
                 state: Optional[dict] = None, top_k: int = 4,
                 expert_steps: int = 2, horizon: int = 500, **kw):
        kw.setdefault("window", top_k)
        super().__init__(expert_steps=expert_steps, **kw)
        self.top_k = max(1, min(int(top_k), self.n_actions))
        # composition, not inheritance: the net half is a LearnedPolicy so
        # state handling (env default, validation, versioning) stays in one
        # place, and state_dict persistence keeps HybridPolicy's agent form
        self.net = LearnedPolicy(featurizer=featurizer, state=state,
                                 n_actions=self.n_actions, horizon=horizon)

    @property
    def featurizer(self) -> Optional[LoopFeaturizer]:
        return self.net.featurizer

    @featurizer.setter
    def featurizer(self, fz: Optional[LoopFeaturizer]) -> None:
        self.net.featurizer = fz

    def _build_agent(self) -> None:
        s = self.net.scores(phase=self._t / self.net.horizon)
        if s is None:
            super()._build_agent()
            return
        order = np.argsort(s, kind="stable")
        best = int(order[0])
        self.actions = sorted(int(a) for a in order[: self.top_k])
        self.window = len(self.actions)
        self.agent = self._agent_cls(n_actions=self.window,
                                     initial_state=self.actions.index(best),
                                     **self._agent_kw)
        # seed: the net's pick starts strictly above the 0-initialized
        # alternatives, so post-exploration greedy ties break toward it
        self.agent.q[:, self.actions.index(best)] = REWARD_POSITIVE


# ---------------------------------------------------------------------------
# distillation — an interpretable threshold ladder from the trained net
# ---------------------------------------------------------------------------

@dataclass
class _TreeNode:
    feature: int = -1            # -1 = leaf
    threshold: float = 0.0
    action: int = 0              # leaf payload
    left: Optional["_TreeNode"] = None
    right: Optional["_TreeNode"] = None


@dataclass
class DistilledLadder:
    """A depth-bounded threshold ladder over the named features — the
    interpretable form of a trained net (paper §6 asks for expert rules;
    this extracts them instead of hand-writing them).

    ``predict`` maps feature rows to portfolio indices; ``describe`` prints
    the rules; ``teacher_agreement`` is the fit-set label agreement with the
    net, and ``regret_bound`` the relative extra cost vs the teacher the
    distillation promises (bench-verified on held-out cells)."""

    root: _TreeNode
    max_depth: int
    teacher_agreement: float
    regret_bound: float = 0.10
    feature_names: Tuple[str, ...] = FEATURE_NAMES

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        out = np.zeros(len(X), dtype=np.int64)
        for i, x in enumerate(X):
            node = self.root
            while node.feature >= 0:
                node = node.left if x[node.feature] <= node.threshold \
                    else node.right
            out[i] = node.action
        return out

    def describe(self) -> List[str]:
        """Human-readable rules, one line per leaf."""
        from .portfolio import ALGORITHM_NAMES
        lines: List[str] = []

        def walk(node: _TreeNode, conds: List[str]) -> None:
            if node.feature < 0:
                cond = " and ".join(conds) if conds else "always"
                lines.append(f"if {cond}: {ALGORITHM_NAMES[node.action]}")
                return
            nm = self.feature_names[node.feature]
            walk(node.left, conds + [f"{nm} <= {node.threshold:.3g}"])
            walk(node.right, conds + [f"{nm} > {node.threshold:.3g}"])

        walk(self.root, [])
        return lines

    @property
    def n_leaves(self) -> int:
        def count(node: _TreeNode) -> int:
            return 1 if node.feature < 0 else \
                count(node.left) + count(node.right)
        return count(self.root)


def _gini(labels: np.ndarray, n_actions: int) -> float:
    if len(labels) == 0:
        return 0.0
    p = np.bincount(labels, minlength=n_actions) / len(labels)
    return float(1.0 - (p * p).sum())


def _majority(labels: np.ndarray, n_actions: int) -> int:
    return int(np.argmax(np.bincount(labels, minlength=n_actions)))


def _fit_tree(X: np.ndarray, y: np.ndarray, depth: int, max_depth: int,
              min_leaf: int, n_actions: int) -> _TreeNode:
    if depth >= max_depth or len(y) < 2 * min_leaf or len(set(y)) == 1:
        return _TreeNode(action=_majority(y, n_actions))
    parent = _gini(y, n_actions)
    best = None          # (gain, feature, threshold, mask)
    for f in range(X.shape[1]):
        vals = np.unique(X[:, f])
        if len(vals) < 2:
            continue
        # quantile thresholds bound the split search per feature
        qs = np.quantile(vals, np.linspace(0.1, 0.9, min(len(vals) - 1, 16)))
        for thr in np.unique(qs):
            mask = X[:, f] <= thr
            nl = int(mask.sum())
            if nl < min_leaf or len(y) - nl < min_leaf:
                continue
            w = nl / len(y)
            gain = parent - (w * _gini(y[mask], n_actions)
                             + (1 - w) * _gini(y[~mask], n_actions))
            if best is None or gain > best[0]:
                best = (gain, f, float(thr), mask)
    if best is None or best[0] <= 1e-9:
        return _TreeNode(action=_majority(y, n_actions))
    _, f, thr, mask = best
    return _TreeNode(
        feature=f, threshold=thr,
        left=_fit_tree(X[mask], y[mask], depth + 1, max_depth, min_leaf,
                       n_actions),
        right=_fit_tree(X[~mask], y[~mask], depth + 1, max_depth, min_leaf,
                        n_actions))


def distill_ladder(state_or_policy, X: np.ndarray, max_depth: int = 3,
                   min_leaf: int = 8, regret_bound: float = 0.10
                   ) -> DistilledLadder:
    """Fit an interpretable threshold ladder to the net's decisions over the
    feature rows ``X`` (typically the training transitions).

    ``state_or_policy`` is a learned state dict or a trained
    :class:`LearnedPolicy`.  ``regret_bound`` is the promise the ladder
    ships with: on evaluation data its chosen-cost total must stay within
    ``(1 + regret_bound)`` of the teacher's (``bench_learned`` gates this on
    held-out cells)."""
    if isinstance(state_or_policy, LearnedPolicy):
        params = state_or_policy._params
        if params is None:
            raise ValueError("cannot distill an untrained LearnedPolicy")
    else:
        params = params_from_state(state_or_policy["params"])
    X = np.asarray(X, np.float64)
    scores = mlp_forward(params, X.astype(np.float32))
    y = np.asarray(np.argmin(scores, axis=-1), np.int64)
    n_actions = scores.shape[-1]
    root = _fit_tree(X, y, 0, max_depth, min_leaf, n_actions)
    ladder = DistilledLadder(root=root, max_depth=max_depth,
                             teacher_agreement=0.0,
                             regret_bound=float(regret_bound))
    ladder.teacher_agreement = float((ladder.predict(X) == y).mean())
    return ladder
