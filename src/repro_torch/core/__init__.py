"""repro_torch.core — the scheduling portfolio, its chunk schedules and the
load-imbalance metrics, and the paper's contribution on top of them:
automated (expert-, RL-based, hybrid, simulation-assisted and learned)
selection through one structured policy API (``Observation`` /
``Decision`` / ``SelectionPolicy``).  The policies are host numpy, as in
the reference; only the simulator they drive touches the card."""

from .metrics import (coefficient_of_variation, execution_imbalance,
                      percent_load_imbalance)
from .portfolio import (ADAPTIVE_SET, ALGORITHM_NAMES, DIRECT_CHUNK_SET,
                        N_ALGORITHMS, ChunkAlgorithm, alg_index,
                        apply_chunk_floor, exp_chunk, make_algorithm,
                        make_portfolio)
from .sched import (ADAPTIVE_SCHEDULABLE, SCHEDULABLE, chunk_schedule,
                    staticsteal_schedule, weighted_adaptive_schedule)
from .rewards import (RewardTracker, REWARD_POSITIVE, REWARD_NEUTRAL,
                      REWARD_NEGATIVE, REWARD_TYPES)
from .api import (Observation, Decision, SelectionPolicy, register_reward,
                  get_reward, reward_names)
from .agents import QLearnAgent, SarsaAgent, explore_first_sequence
from .drift import PageHinkley
from .selectors import (FixedPolicy, OraclePolicy, RandomPolicy,
                        ExhaustivePolicy, ExpertPolicy, RLPolicy,
                        QLearnPolicy, SarsaPolicy, HybridPolicy,
                        make_policy, POLICY_NAMES,
                        # deprecated scalar shims
                        Selector, FixedSel, OracleSel, RandomSel,
                        ExhaustiveSel, ExpertSel, QLearnSel, SarsaSel,
                        make_selector, SELECTOR_NAMES)
from .simpolicy import (Candidate, SimAssistedHybrid, SimPolicy,
                        SimUnavailable, SIM_POLICY_ENV, SIM_POLICY_NAMES,
                        is_sim_policy, resolve_sim_policy)
from .learned import (DistilledLadder, FEATURE_NAMES, FEATURE_VERSION,
                      LEARNED_POLICY_NAMES, LEARNED_STATE_ENV, LearnedHybrid,
                      LearnedPolicy, LoopFeaturizer, N_FEATURES,
                      distill_ladder, is_learned_policy,
                      make_learned_state, mlp_forward, params_from_state,
                      params_to_state, resolve_default_state,
                      set_default_state)
from .service import RegionInstance, SelectionService
from .persistence import (AgentStatsLogger, save_agent, load_agent,
                          save_policy_state, load_policy_state,
                          system_fingerprint, warm_start)

__all__ = [
    "coefficient_of_variation", "execution_imbalance",
    "percent_load_imbalance", "ADAPTIVE_SET", "ALGORITHM_NAMES",
    "DIRECT_CHUNK_SET", "N_ALGORITHMS", "ChunkAlgorithm", "alg_index",
    "apply_chunk_floor", "exp_chunk", "make_algorithm", "make_portfolio",
    "ADAPTIVE_SCHEDULABLE", "SCHEDULABLE", "chunk_schedule",
    "staticsteal_schedule", "weighted_adaptive_schedule",
    "RewardTracker", "REWARD_POSITIVE", "REWARD_NEUTRAL", "REWARD_NEGATIVE",
    "REWARD_TYPES",
    # structured selection API
    "Observation", "Decision", "SelectionPolicy", "register_reward",
    "get_reward", "reward_names", "FixedPolicy", "OraclePolicy",
    "RandomPolicy", "ExhaustivePolicy", "ExpertPolicy", "RLPolicy",
    "QLearnPolicy", "SarsaPolicy", "HybridPolicy", "make_policy",
    "POLICY_NAMES", "RegionInstance", "SelectionService",
    # simulation-assisted selection (SimAS-style)
    "Candidate", "SimPolicy", "SimAssistedHybrid", "SimUnavailable",
    "SIM_POLICY_ENV", "SIM_POLICY_NAMES", "is_sim_policy",
    "resolve_sim_policy", "PageHinkley",
    # offline-trained learned selection
    "LearnedPolicy", "LearnedHybrid", "LoopFeaturizer", "DistilledLadder",
    "distill_ladder", "FEATURE_NAMES",
    "FEATURE_VERSION", "N_FEATURES", "LEARNED_POLICY_NAMES",
    "LEARNED_STATE_ENV", "is_learned_policy", "make_learned_state",
    "mlp_forward", "params_from_state", "params_to_state",
    "set_default_state", "resolve_default_state",
    # agents + persistence
    "QLearnAgent", "SarsaAgent", "explore_first_sequence",
    "AgentStatsLogger", "save_agent", "load_agent", "save_policy_state",
    "load_policy_state", "system_fingerprint", "warm_start",
    # deprecated scalar shims
    "Selector", "FixedSel", "OracleSel", "RandomSel", "ExhaustiveSel",
    "ExpertSel", "QLearnSel", "SarsaSel", "make_selector", "SELECTOR_NAMES",
]
