"""``SelectionService`` and warm-start persistence of the port
(``repro_torch.core.service`` / ``persistence``) against the reference's:
the same region seeds and histories, ``decide()`` without feedback a pure
peek, and Q-table stores that one package writes and the other reads — in
both directions — while a corrupt file, a changed reward or a changed
``n_actions`` each start cold instead of crashing."""

import json
import os
import warnings

import numpy as np
import pytest

import repro.core as J
from repro.core import persistence as j_persist
from repro.core import service as j_service

pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import persistence as p_persist  # noqa: E402
from repro_torch.core import service as p_service  # noqa: E402

PACKAGES = {"reference": J, "port": P}
DIRECTIONS = [("reference", "port"), ("port", "reference")]
BEST = 9


def obs(pkg, action: int, t: int, rng=None):
    cost = 1.0 + 0.3 * abs(action - BEST)
    if rng is not None:
        cost *= float(rng.lognormal(0.0, 0.02))
    return pkg.Observation(loop_time=cost, lib=5.0 if action >= 7 else 60.0,
                           instance=t)


def run_service(svc, pkg, regions, T: int, seed: int = 0):
    """Drive every region ``T`` instances with seeded outcomes; the actions
    taken, region by region."""
    rng = np.random.default_rng(seed)
    out = {r: [] for r in regions}
    for t in range(T):
        for r in regions:
            with svc.instance(r) as inst:
                out[r].append((inst.action, inst.decision.phase))
                inst.report(observation=obs(pkg, inst.action, t, rng))
    return out


def states(svc, regions):
    return {r: json.loads(json.dumps(svc.policy(r).state_dict()))
            for r in regions}


@pytest.mark.parametrize("region", [
    "L0", "gravity", 0, 17, ("app", "L2"), "a/b", ""])
@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 123456789])
def test_region_seeds_bit_equal(region, seed):
    assert p_service._stable_region_seed(seed, region) == \
        j_service._stable_region_seed(seed, region)


@pytest.mark.parametrize("method,kw", [
    ("RandomSel", {"seed": 42}), ("QLearn", {"reward": "LT"}),
    ("SARSA", {"reward": "LIB"}), ("Hybrid", {"reward": "LT+LIB"}),
    ("ExhaustiveSel", {}), ("ExpertSel", {})])
def test_service_histories_bit_equal(method, kw):
    regions = ["L0", "L1", ("queue", 3)]
    ps, js = P.SelectionService(method, **kw), J.SelectionService(method, **kw)
    assert run_service(ps, P, regions, 180) == run_service(js, J, regions, 180)
    for r in regions:
        assert ps.history(r) == js.history(r)
        assert [vars(o) for o in ps._regions[r].observations] == \
            [vars(o) for o in js._regions[r].observations]
    assert states(ps, regions) == states(js, regions)
    assert ps.regions == js.regions


def test_identical_services_give_identical_random_streams():
    a = run_service(P.SelectionService("RandomSel", seed=42), P, ["w"], 40)
    b = run_service(P.SelectionService("RandomSel", seed=42), P, ["w"], 40)
    c = run_service(P.SelectionService("RandomSel", seed=43), P, ["w"], 40)
    assert a == b != c


@pytest.mark.parametrize("name", ["RandomSel", "ExhaustiveSel", "ExpertSel",
                                  "QLearn", "SARSA", "Hybrid", "Oracle",
                                  "Learned", "LearnedHybrid"])
def test_decide_without_feedback_is_a_pure_peek(name):
    kw = {"seed": 11, "best_fn": lambda t: 3}
    p = P.make_policy(name, **kw)
    rng = np.random.default_rng(0)
    for t in range(60):                 # into each policy's later phases
        d = p.decide()
        p.feedback(d, obs(P, d.action, t, rng))
    before = json.dumps(p.state_dict())
    gen = getattr(p, "rng", None)
    rng_state = None if gen is None else gen.bit_generator.state
    first = p.decide()
    assert all(p.decide() == first for _ in range(10)), name
    assert json.dumps(p.state_dict()) == before
    if gen is not None:
        assert gen.bit_generator.state == rng_state
    # through the service: an instance without a report commits nothing
    svc = P.SelectionService(name, **kw)
    for _ in range(3):
        with svc.instance("r") as inst:
            inst.action
    assert svc.history("r") == [] and svc._regions["r"].instances == 0


def test_report_variants_bit_equal():
    pe = (0.5, 0.9, 1.3, 0.7)
    for kw in ({"pe_times": pe}, {"pe_times": pe, "loop_time": 2.0},
               {"pe_times": pe, "lib": 1.5, "tail_latency": 0.2},
               {"loop_time": 1.1, "lib": 3.0, "throughput": 5.0}):
        got = []
        for pkg in (P, J):
            svc = pkg.SelectionService("QLearn")
            with svc.instance("r") as inst:
                o = inst.report(**kw)
            got.append(vars(o))
        assert got[0] == got[1], kw
    with pytest.raises(ValueError, match="loop_time"):
        P.SelectionService("QLearn").instance("r").report()


def test_overrides_and_scalar_shims():
    svc = P.SelectionService("QLearn", reward="LT",
                             overrides={"io": {"method": "ExhaustiveSel"}})
    svc.set_policy("ladder", "ExpertSel")
    assert [svc.policy(r).name for r in ("io", "ladder", "compute")] == \
        ["ExhaustiveSel", "ExpertSel", "QLearn"]
    with pytest.raises(ValueError, match="live policy"):
        svc.set_policy("io", "SARSA")
    svc = P.SelectionService("ExhaustiveSel")
    for t in range(12):
        a = svc.begin("L0")
        assert a == t
        svc.end("L0", a, 1.0 + 0.1 * abs(a - 4), 3.0)
    assert svc.begin("L0") == 4


def test_service_default_method_reads_the_env(monkeypatch):
    monkeypatch.delenv(P.SIM_POLICY_ENV, raising=False)
    assert P.SelectionService().policy("r").name == "QLearn"
    monkeypatch.setenv(P.SIM_POLICY_ENV, "simhybrid")

    class Stub:
        def price(self, cands):
            raise P.SimUnavailable("no context")

    svc = P.SelectionService(simulator=Stub())
    assert svc.policy("r").name == "SimHybrid"


def test_fingerprint_and_store_paths_match():
    assert p_persist.system_fingerprint() == j_persist.system_fingerprint()
    for args in (("d", "L0", "sys"), ("d", "a/b", "x/y", "policy")):
        assert p_persist._key_path(*args) == j_persist._key_path(*args)


@pytest.mark.parametrize("method,kw", [
    ("QLearn", {"reward": "LT"}), ("SARSA", {"reward": "LIB"}),
    ("Hybrid", {"reward": "LT"})])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_warm_start_across_packages(tmp_path, writer, reader, method, kw):
    W, R = PACKAGES[writer], PACKAGES[reader]
    regions = ["gravity", "L1"]
    with W.SelectionService(method, store_dir=str(tmp_path), **kw) as w:
        run_service(w, W, regions, 220)
    assert len(os.listdir(tmp_path)) == 2
    r = R.SelectionService(method, store_dir=str(tmp_path), **kw)
    assert all(r.warm_started(g) for g in regions)
    assert all(not r.policy(g).learning for g in regions)
    assert states(r, regions) == states(w, regions)
    # and both packages carry on from there alike
    twin = W.SelectionService(method, store_dir=str(tmp_path), **kw)
    assert run_service(r, R, regions, 30, seed=5) == \
        run_service(twin, W, regions, 30, seed=5)


def _trained_store(pkg, tmp_path, method="QLearn", **kw):
    with pkg.SelectionService(method, reward="LT", store_dir=str(tmp_path),
                              **kw) as svc:
        run_service(svc, pkg, ["gravity"], 200)
    path, = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    return path


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_corrupt_store_starts_cold(tmp_path, writer):
    path = _trained_store(PACKAGES[writer], tmp_path)
    with open(path, "w") as f:
        f.write("{not json")
    svc = P.SelectionService("QLearn", reward="LT", store_dir=str(tmp_path))
    with pytest.warns(UserWarning, match="corrupt"):
        assert not svc.warm_started("gravity")
    assert svc.policy("gravity").learning


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_changed_reward_starts_cold(tmp_path, writer):
    _trained_store(PACKAGES[writer], tmp_path)
    svc = P.SelectionService("QLearn", reward="LIB", store_dir=str(tmp_path))
    assert not svc.warm_started("gravity")
    assert svc.policy("gravity").learning
    # the reward match is case-insensitive, as the reference's
    svc = P.SelectionService("QLearn", reward="lt", store_dir=str(tmp_path))
    assert svc.warm_started("gravity")


@pytest.mark.parametrize("writer", list(PACKAGES))
@pytest.mark.parametrize("method", ["QLearn", "Hybrid"])
def test_changed_n_actions_starts_cold(tmp_path, writer, method):
    _trained_store(PACKAGES[writer], tmp_path, method=method)
    svc = P.SelectionService(method, reward="LT", store_dir=str(tmp_path),
                             n_actions=8)
    assert not svc.warm_started("gravity")
    assert svc.policy("gravity").learning
    assert svc.policy("gravity").decide().action < 8


def test_wrong_typed_and_truncated_records_start_cold(tmp_path):
    path = _trained_store(P, tmp_path)
    rec = json.load(open(path))
    for bad in ({**rec, "state": {**rec["state"], "agent": {
                    **rec["state"]["agent"], "state": "x"}}},
                {**rec, "state": {**rec["state"], "agent": {"q": []}}},
                {**rec, "method": "SARSA"}):
        with open(path, "w") as f:
            json.dump(bad, f)
        svc = P.SelectionService("QLearn", reward="LT",
                                 store_dir=str(tmp_path))
        assert not svc.warm_started("gravity")
        assert svc.policy("gravity").learning


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_agent_level_helpers_across_packages(tmp_path, writer, reader):
    W, R = PACKAGES[writer], PACKAGES[reader]
    agent = W.QLearnAgent()
    rng = np.random.default_rng(1)
    for _ in range(160):
        agent.observe(agent.select(), float(rng.lognormal()))
    W.save_agent(agent, str(tmp_path), "L0", "sysA")
    fresh = R.warm_start(R.QLearnAgent(),
                         R.load_agent(str(tmp_path), "L0", "sysA"))
    assert json.dumps(fresh.state_dict()) == json.dumps(agent.state_dict())
    assert R.load_agent(str(tmp_path), "L9", "sysA") is None
    for pkg, d in ((W, "w"), (R, "r")):
        log = pkg.AgentStatsLogger(str(tmp_path / d))
        log.log("L0", 3, agent)
    assert (tmp_path / "w" / "L0.jsonl").read_text() == \
        (tmp_path / "r" / "L0.jsonl").read_text()


def test_policy_state_files_are_byte_equal(tmp_path):
    out = []
    for name, pkg in PACKAGES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            path = _trained_store(pkg, tmp_path / name, method="Hybrid")
        out.append(open(path).read())
    assert out[0] == out[1]
