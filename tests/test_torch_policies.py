"""The selection policies of the port (``repro_torch.core``) against the
reference's (``repro.core``): every name in ``POLICY_NAMES`` fed the same
numpy-seeded observation stream in both packages must take the same
decisions — action, chunk parameter, phase and confidence — and end in the
same ``state_dict()``, bit for bit.  Simulation-assisted policies price
through a stub simulator (as ``tests/test_simpolicy.py`` does); learned
policies get one seeded state and each package's own featurizer.  Also the
pieces under them: the reward registry, the Eq. 11 tracker, the agents'
explore-first circuit, the fuzzy systems and ``PageHinkley``."""

import json
import warnings

import numpy as np
import pytest

import repro.core as J
import repro.core.learned as JL
from repro.sim import get_application as j_app
from repro.sim import get_system as j_sys

pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
import repro_torch.core.learned as PL  # noqa: E402
from repro_torch.core import fuzzy as p_fuzzy  # noqa: E402
from repro.core import fuzzy as j_fuzzy  # noqa: E402
from repro_torch.sim import get_application as p_app  # noqa: E402
from repro_torch.sim import get_system as p_sys  # noqa: E402

HIDDEN = 16
BUILTIN_REWARDS = ("lt", "lib", "p95", "throughput", "lt+lib")
T_STREAM = 220          # past QLearn's 144-instance explore-first circuit


def seeded_state(seed: int = 3, reward: str = "LT") -> dict:
    """A learned state from numpy-seeded random weights (the reference's
    ``make_learned_state``; the port's must produce the same record)."""
    rng = np.random.default_rng(seed)
    shapes = {"w0": (J.N_FEATURES, HIDDEN), "b0": (HIDDEN,),
              "w1": (HIDDEN, HIDDEN), "b1": (HIDDEN,),
              "w2": (HIDDEN, J.N_ALGORITHMS), "b2": (J.N_ALGORITHMS,)}
    params = {k: (0.4 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    return JL.make_learned_state(params, reward=reward, meta={"seed": seed})


class StubSim:
    """Candidate simulator over a fixed cost vector, in one package's
    types: 12 algorithms at the default chunk and at chunk 7; unavailable
    on the steps in ``down`` (the policies then fall back)."""

    def __init__(self, pkg, costs, down=()):
        self.pkg = pkg
        self.costs = np.asarray(costs, dtype=np.float64)
        self.down = set(down)
        self.calls = 0

    def candidates(self):
        C = self.pkg.Candidate
        return ([C(a) for a in range(len(self.costs))]
                + [C(a, 7) for a in range(len(self.costs))])

    def price(self, cands):
        self.calls += 1
        if self.calls in self.down:
            raise self.pkg.SimUnavailable("stub is down")
        return [self.pkg.Observation(
            loop_time=float(self.costs[c.alg]) * (
                1.0 if c.chunk_param is None else 0.97),
            lib=float(3 * c.alg)) for c in cands]


def featurizer(pkg_app, pkg_sys, pkg):
    fz = pkg.LoopFeaturizer(pkg_sys("epyc"), horizon=T_STREAM)
    fz.set_context(pkg_app("mandelbrot").loops(0)[1], 0)
    return fz


def policy_kwargs(pkg, name: str, reward):
    """One package's constructor arguments for ``make_policy(name)``."""
    kw = {} if reward is None else {"reward": reward}
    low = name.lower()
    if low == "fixed":
        kw["algorithm"] = 7
    elif low == "oracle":
        kw["best_fn"] = lambda t: (5 * t + 3) % 12
    elif low == "randomsel":
        kw["seed"] = 11
    elif pkg.is_sim_policy(name):
        costs = np.random.default_rng(5).uniform(1.0, 2.0, 12)
        costs[4] = 0.6
        kw["simulator"] = StubSim(pkg, costs, down=(2, 9))
    elif pkg.is_learned_policy(name):
        app, sys_ = (j_app, j_sys) if pkg is J else (p_app, p_sys)
        kw["featurizer"] = featurizer(app, sys_, pkg)
        kw["state"] = seeded_state()
    return kw


def drive(pkg, policy, T: int = T_STREAM, seed: int = 0):
    """Decide (twice: a peek, then the act), observe a seeded outcome that
    depends on the action and shifts at T/2, feed it back."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1.0, 2.0, 64)
    trace = []
    for t in range(T):
        policy.decide()
        d = policy.decide()
        trace.append((d.action, d.chunk_param, d.phase, d.confidence))
        shift = 2.5 if (t >= T // 2 and d.action % 3 == 0) else 1.0
        lt = base[d.action % 64] * shift * float(rng.lognormal(0.0, 0.05))
        obs = pkg.Observation(loop_time=lt, lib=float(rng.uniform(0, 30)),
                              throughput=float(1.0 / lt),
                              tail_latency=float(lt * rng.uniform(1, 1.5)),
                              instance=t)
        policy.feedback(d, obs)
    return trace


def as_json(state):
    return None if state is None else json.loads(json.dumps(state))


CASES = [(name, None) for name in J.POLICY_NAMES] + [
    ("QLearn", "LIB"), ("QLearn", "p95"), ("SARSA", "LT"),
    ("SARSA", "throughput"), ("Hybrid", "LT+LIB"), ("SimPolicy", "LIB"),
    ("LearnedHybrid", "LIB")]


@pytest.mark.parametrize("name,reward", CASES,
                         ids=[f"{n}-{r}" for n, r in CASES])
def test_policy_stream_bit_equal(name, reward):
    assert P.POLICY_NAMES == J.POLICY_NAMES
    jp = J.make_policy(name, **policy_kwargs(J, name, reward))
    pp = P.make_policy(name, **policy_kwargs(P, name, reward))
    assert type(pp).__name__ == type(jp).__name__
    assert pp.name == jp.name
    assert drive(P, pp) == drive(J, jp)
    assert as_json(pp.state_dict()) == as_json(jp.state_dict())
    assert (pp.learning, pp.learning_steps) == (jp.learning,
                                                jp.learning_steps)


@pytest.mark.parametrize("alias", [
    "random", "exhaustive", "expert", "q-learn", "q_learn", "hybridsel",
    "expert+rl", "simas", "sim-hybrid", "simreact", "reactivesimhybrid",
    "adaptivesim", "mlp", "learnedrl"])
def test_aliases_build_the_same_policy(alias):
    jp = J.make_policy(alias, **policy_kwargs(J, alias, None))
    pp = P.make_policy(alias, **policy_kwargs(P, alias, None))
    assert (type(pp).__name__, pp.name) == (type(jp).__name__, jp.name)
    assert drive(P, pp, T=40) == drive(J, jp, T=40)


def test_unknown_names_raise_listing_the_registry():
    with pytest.raises(ValueError) as pe:
        P.make_policy("NoSuchPolicy")
    with pytest.raises(ValueError) as je:
        J.make_policy("NoSuchPolicy")
    assert str(pe.value) == str(je.value)
    assert "SimHybrid" in str(pe.value) and "Learned" in str(pe.value)
    # other tests may register extra rewards in either package's registry,
    # so the reward message is held to its own registry
    with pytest.raises(ValueError) as pe:
        P.get_reward("nope")
    assert str(pe.value) == (f"unknown reward 'nope'; registered: "
                             f"{P.reward_names()}")
    assert set(BUILTIN_REWARDS) <= set(P.reward_names())
    # a sim policy without a simulator names what it needs
    with pytest.raises(ValueError, match="simulator"):
        P.make_policy("SimPolicy")


def test_reward_functions_and_tracker_bit_equal():
    assert set(BUILTIN_REWARDS) <= set(P.reward_names())
    rng = np.random.default_rng(1)
    for i in range(200):
        kw = {"loop_time": float(rng.lognormal(0, 1)),
              "lib": float(rng.uniform(0, 60))}
        if i % 3 == 0:
            kw["tail_latency"] = float(rng.uniform(0, 5))
        if i % 4 == 0:
            kw["throughput"] = float(rng.uniform(1, 100))
        if i % 5 == 0:
            kw["pe_times"] = tuple(float(x) for x in rng.uniform(0, 2, 7))
        for name in BUILTIN_REWARDS:
            assert P.get_reward(name)(P.Observation(**kw)) == \
                J.get_reward(name)(J.Observation(**kw)), (name, kw)
    pt, jt = P.RewardTracker(), J.RewardTracker()
    xs = rng.lognormal(0, 0.3, 300)
    assert [pt.reward(x) for x in xs] == [jt.reward(x) for x in xs]
    assert pt.extrema == jt.extrema and pt.count == jt.count
    assert (P.REWARD_POSITIVE, P.REWARD_NEUTRAL, P.REWARD_NEGATIVE,
            P.REWARD_TYPES) == (J.REWARD_POSITIVE, J.REWARD_NEUTRAL,
                                J.REWARD_NEGATIVE, J.REWARD_TYPES)


def test_observation_constructors_bit_equal():
    rng = np.random.default_rng(2)
    for _ in range(20):
        pe = rng.uniform(0.1, 2.0, 9)
        po = P.Observation.from_pe_times(pe, instance=3)
        jo = J.Observation.from_pe_times(pe, instance=3)
        assert vars(po) == vars(jo)
    lt, lb = rng.uniform(0, 1, 17), rng.uniform(0, 40, 17)
    assert [vars(o) for o in P.Observation.batch(lt, lb)] == \
        [vars(o) for o in J.Observation.batch(lt, lb)]
    assert [vars(o) for o in P.Observation.batch(lt)] == \
        [vars(o) for o in J.Observation.batch(lt)]
    d = P.Decision(action=3)
    assert d.with_instance_defaults(9).chunk_param == 9
    assert P.Decision(3, 5).with_instance_defaults(9).chunk_param == 5


@pytest.mark.parametrize("n,start", [(12, 0), (12, 7), (5, 2), (1, 0)])
def test_explore_first_sequence_and_agents(n, start):
    assert P.explore_first_sequence(n, start) == \
        J.explore_first_sequence(n, start)
    rng = np.random.default_rng(n + start)
    for pc, jc in ((P.QLearnAgent, J.QLearnAgent),
                   (P.SarsaAgent, J.SarsaAgent)):
        pa = pc(n_actions=n, initial_state=start,
                decay_mode="multiplicative")
        ja = jc(n_actions=n, initial_state=start,
                decay_mode="multiplicative")
        for x in rng.lognormal(0, 0.2, n * n + 30):
            a = pa.select()
            assert a == ja.select()
            pa.observe(a, x)
            ja.observe(a, x)
        assert as_json(pa.state_dict()) == as_json(ja.state_dict())


def test_fuzzy_systems_bit_equal():
    rng = np.random.default_rng(4)
    pi, ji = p_fuzzy.make_initial_system(), j_fuzzy.make_initial_system()
    pd, jd = p_fuzzy.make_diff_system(), j_fuzzy.make_diff_system()
    for _ in range(500):
        lib, tp = rng.uniform(-5, 110), rng.uniform(-0.5, 3.5)
        assert pi.infer(lib, tp) == ji.infer(lib, tp)
        dt, dl = rng.uniform(-1.2, 1.2), rng.uniform(-110, 110)
        assert pd.infer(dt, dl) == jd.infer(dt, dl)
        a, b, c = sorted(rng.uniform(-1, 1, 3))
        x = rng.uniform(-1.5, 1.5)
        for args in ((x, a, b, c), (x, a, a, c), (x, a, c, c)):
            assert p_fuzzy.tri(*args) == j_fuzzy.tri(*args)
    assert p_fuzzy.INITIAL_RULES == j_fuzzy.INITIAL_RULES
    assert p_fuzzy.DIFF_RULES == j_fuzzy.DIFF_RULES


def test_page_hinkley_bit_equal():
    rng = np.random.default_rng(6)
    xs = np.concatenate([rng.normal(0.0, 0.1, 300), rng.normal(1.0, 0.1, 300),
                         rng.normal(-0.5, 0.1, 300)])
    for kw in ({}, {"delta": 0.01, "threshold": 0.3, "min_obs": 3}):
        pd, jd = P.PageHinkley(**kw), J.PageHinkley(**kw)
        got = [pd.update(x) for x in xs]
        assert got == [jd.update(x) for x in xs]
        assert pd.n_detections == jd.n_detections > 0
        assert vars(pd) == vars(jd)


def test_learned_forward_featurizer_and_state_bit_equal():
    state = seeded_state()
    assert PL.make_learned_state(PL.params_from_state(state["params"]),
                                 meta={"seed": 3}) == state
    assert PL.FEATURE_NAMES == JL.FEATURE_NAMES
    assert PL.FEATURE_VERSION == JL.FEATURE_VERSION
    pp = PL.params_from_state(state["params"])
    jp = JL.params_from_state(state["params"])
    x = np.random.default_rng(7).standard_normal(
        (33, J.N_FEATURES)).astype(np.float32)
    got, want = PL.mlp_forward(pp, x), JL.mlp_forward(jp, x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the featurizer's rows, perturbation telemetry None included
    for app in ("mandelbrot", "tc", "sphynx"):
        for sysname in ("broadwell", "epyc", "cascadelake"):
            pf = P.LoopFeaturizer(p_sys(sysname), horizon=50)
            jf = J.LoopFeaturizer(j_sys(sysname), horizon=50)
            for t in (0, 7):
                for prof_p, prof_j in zip(p_app(app).loops(t),
                                          j_app(app).loops(t)):
                    for cp in (0, 97):
                        pf.set_context(prof_p, cp, perturb=None)
                        jf.set_context(prof_j, cp, perturb=None)
                        for ph in (0.0, 0.3, 1.7):
                            np.testing.assert_array_equal(
                                pf.features(ph), jf.features(ph))
    with pytest.raises(P.SimUnavailable):
        P.LoopFeaturizer(p_sys("epyc")).features()


def test_learned_state_validation_and_default_state(tmp_path, monkeypatch):
    bad = dict(seeded_state(), feature_version=99)
    with pytest.raises(ValueError, match="feature_version"):
        P.LearnedPolicy(state=bad)
    monkeypatch.delenv(P.LEARNED_STATE_ENV, raising=False)
    assert P.LEARNED_STATE_ENV == J.LEARNED_STATE_ENV == "REPRO_LEARNED_STATE"
    assert PL.resolve_default_state() is None
    path = tmp_path / "state.json"
    path.write_text(json.dumps(seeded_state()))
    monkeypatch.setenv(P.LEARNED_STATE_ENV, str(path))
    assert P.resolve_default_state() == seeded_state()
    assert P.LearnedPolicy().trained
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="REPRO_LEARNED_STATE"):
        assert P.resolve_default_state() is None
    P.set_default_state(seeded_state(9))
    try:
        assert P.LearnedPolicy().state_dict()["meta"] == {"seed": 9}
    finally:
        P.set_default_state(None)


def test_resolve_sim_policy_env(monkeypatch):
    assert P.SIM_POLICY_ENV == J.SIM_POLICY_ENV == "REPRO_SIM_POLICY"
    monkeypatch.delenv(P.SIM_POLICY_ENV, raising=False)
    assert P.resolve_sim_policy() is None
    assert P.resolve_sim_policy("QLearn") == "QLearn"
    for spelling in ("simhybrid", "SIMAS", "reactivesim", "AwareSim"):
        monkeypatch.setenv(P.SIM_POLICY_ENV, spelling)
        assert P.resolve_sim_policy() == J.resolve_sim_policy()
    monkeypatch.setenv(P.SIM_POLICY_ENV, "SimPolcy")
    with pytest.raises(ValueError, match=P.SIM_POLICY_ENV):
        P.resolve_sim_policy()


def test_deprecated_selector_shims_bit_equal():
    for name, kw in (("RandomSel", {"seed": 4}), ("QLearn", {}),
                     ("SARSA", {"reward_type": "LIB"}),
                     ("ExhaustiveSel", {}), ("Fixed", {"algorithm": 2}),
                     ("Hybrid", {"reward": "LT"})):
        with pytest.warns(DeprecationWarning, match="make_policy"):
            ps = P.make_selector(name, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            js = J.make_selector(name, **kw)
        assert type(ps).__name__ == type(js).__name__
        rng = np.random.default_rng(8)
        for _ in range(160):
            a = ps.select()
            assert a == js.select()
            lt, lib = float(rng.lognormal()), float(rng.uniform(0, 30))
            ps.observe(a, lt, lib)
            js.observe(a, lt, lib)
    assert P.SELECTOR_NAMES == J.SELECTOR_NAMES
