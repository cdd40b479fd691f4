"""The port's fleet under faults (``repro_torch.sim.perturb``'s fleet half,
``repro_torch.serving.fleet.{recovery,journal}`` and the fault paths of
``FleetSimulator``) against the reference on the CPU.

The port on ``TorchBatchedBackend(device="cpu")`` is held against the
reference on its ``"jax"`` backend (and the ``"python"`` engines against
each other).  The tolerance is exact everywhere: summaries, ``recovery``
dicts included, with ``==``, latencies with ``np.array_equal``.  Journals
are one format: a run the reference journaled resumes in the port and
finishes equal to the reference's uninterrupted run."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import AdmissionControl as JAdmission  # noqa: E402
from repro.serving import FleetSimulator as JFleet  # noqa: E402
from repro.serving import RecoveryPolicy as JRecovery  # noqa: E402
from repro.serving import RunJournal as JJournal  # noqa: E402
from repro.serving import make_trace as j_make_trace  # noqa: E402
from repro.serving.fleet.recovery import BASELINE_RECOVERY as J_BASE  # noqa: E402
from repro.serving.fleet.recovery import RecoveryLedger as JLedger  # noqa: E402
from repro.sim import perturb as JP  # noqa: E402
from repro_torch import TorchBatchedBackend  # noqa: E402
from repro_torch.serving import (AdmissionControl, FleetSimulator,  # noqa: E402
                                 RecoveryLedger, RecoveryPolicy, RunJournal,
                                 make_trace)
from repro_torch.serving.fleet import BASELINE_RECOVERY, RetryEntry  # noqa: E402
from repro_torch.sim import (FleetPerturb, GroupSlowdown,  # noqa: E402
                             ReplicaFailure, ReplicaStraggler)

TORCH = TorchBatchedBackend(device="cpu")
BURSTY = dict(base_rate=2000.0, burst_factor=6.0, p_enter=0.015, p_exit=0.05)


def _j_perturb(p):
    """The reference's ``FleetPerturb`` with the same events."""
    if p is None:
        return None
    return JP.FleetPerturb(
        events=tuple(JP.GroupSlowdown(**dataclasses.asdict(e))
                     for e in p.events),
        failures=tuple(JP.ReplicaFailure(**dataclasses.asdict(e))
                       for e in p.failures),
        stragglers=tuple(JP.ReplicaStraggler(**dataclasses.asdict(e))
                         for e in p.stragglers))


def _j(obj):
    """The reference's twin of a port dataclass (recovery, admission)."""
    if obj is None:
        return None
    cls = {RecoveryPolicy: JRecovery, AdmissionControl: JAdmission}
    return cls[type(obj)](**dataclasses.asdict(obj))


def _fleets(engine="torch", n_groups=3, replicas=4, router="whatif",
            perturb=None, recovery=None, **kw):
    kw.setdefault("selector", "SimPolicy")
    pb, jb = {"torch": (TORCH, "jax"),
              "python": ("python", "python")}[engine]
    jkw = {k: (_j(v) if isinstance(v, AdmissionControl) else v)
           for k, v in kw.items()}
    port = FleetSimulator(n_groups=n_groups, replicas_per_group=replicas,
                          router=router, seed=0, backend=pb,
                          perturb=perturb, recovery=recovery, **kw)
    ref = JFleet(n_groups=n_groups, replicas_per_group=replicas,
                 router=router, seed=0, backend=jb,
                 perturb=_j_perturb(perturb), recovery=_j(recovery), **jkw)
    return port, ref


def _traces(n, seed=7, **params):
    params = {**BURSTY, **params}
    return (make_trace("bursty", n, seed=seed, **params),
            j_make_trace("bursty", n, seed=seed, **params))


def _same(rep, jrep):
    assert rep.summary() == jrep.summary()
    assert np.array_equal(rep.latencies, jrep.latencies)
    assert rep.per_group == jrep.per_group


# ---------------------------------------------------------------------------
# FleetPerturb
# ---------------------------------------------------------------------------

PERTURB = FleetPerturb(
    events=(GroupSlowdown(group=0, factor=3.0, t0=0.5, t1=2.0),
            GroupSlowdown(group=5, factor=1.5, t0=1.0)),
    failures=(ReplicaFailure(group=1, t0=1.0, t1=3.0),
              ReplicaFailure(group=2, t0=0.2, replicas=(0, 5)),
              ReplicaFailure(group=0, t0=2.5, t1=2.6, replicas=(0, 1, 2, 3)),
              ReplicaFailure(group=4, t0=1.5, t1=1.8)),
    stragglers=(ReplicaStraggler(group=0, factor=4.0, t0=0.1, t1=1.1,
                                 replicas=(1,)),
                ReplicaStraggler(group=2, factor=2.0, t0=0.7)))


@pytest.mark.parametrize("now", [0.0, 0.15, 0.5, 1.0, 1.05, 1.6, 2.0, 2.55,
                                 3.0, 9.0])
@pytest.mark.parametrize("G,R", [(3, 4), (4, 8)])
def test_fleet_perturb_methods_equal_reference(now, G, R):
    ref = _j_perturb(PERTURB)
    assert np.array_equal(PERTURB.slowdowns(now, G), ref.slowdowns(now, G))
    got, want = PERTURB.replica_state(now, G, R), ref.replica_state(now, G, R)
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert PERTURB.next_change(now) == ref.next_change(now)
    for g in range(G):
        for hi in (now + 0.01, now + 1.0, np.inf):
            assert PERTURB.failure_start(g, G, R, now, hi) == \
                ref.failure_start(g, G, R, now, hi)
    assert PERTURB.has_replica_events and \
        not FleetPerturb(events=PERTURB.events).has_replica_events
    assert FleetPerturb().replica_state(now, G, R) is None
    assert FleetPerturb().next_change(now) is None


def test_perturbation_events_are_frozen_and_normalised():
    f = ReplicaFailure(group=1, replicas=[3, 4])
    assert f.replicas == (3, 4)
    assert ReplicaStraggler(group=0, factor=2.0, replicas=[1]).replicas == (1,)
    p = FleetPerturb(failures=[f])
    assert isinstance(p.failures, tuple) and hash(p) == hash(
        FleetPerturb(failures=(f,)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.group = 2


# ---------------------------------------------------------------------------
# recovery policy and ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(jitter=0.5), dict(jitter=1.0, backoff_base=0.01,
                                   backoff_factor=3.0, backoff_cap=0.2),
    dict(backoff_base=0.0, jitter=0.7), dict(max_retries=-1)])
def test_backoff_and_budget_equal_reference(kw):
    pol, ref = RecoveryPolicy(**kw), JRecovery(**kw)
    for rid in (0, 1, 17, 59999):
        for attempt in range(1, 9):
            for seed in (0, 3):
                assert pol.backoff(rid, attempt, seed) == \
                    ref.backoff(rid, attempt, seed)
            assert pol.exhausted(attempt) == ref.exhausted(attempt)
    assert dataclasses.asdict(BASELINE_RECOVERY) == \
        dataclasses.asdict(J_BASE)


def test_recovery_policy_validation():
    with pytest.raises(ValueError, match="timeout"):
        RecoveryPolicy(timeout=0.0)
    with pytest.raises(ValueError, match="backoff"):
        RecoveryPolicy(backoff_base=-1.0)


def test_ledger_equals_reference():
    led, ref = RecoveryLedger(), JLedger()
    for x in (led, ref):
        x.record_retry(1)
        x.record_retry(1)
        x.record_retry(4)
        x.dead_letter(2, "max_retries")
        x.dead_letter(3, "shed")
        x.shed += 1
    assert led.summary() == ref.summary()
    assert led.attempt_of(1) == 2 and led.attempt_of(9) == 0
    with pytest.raises(AssertionError, match="accounting"):
        led.check(10, 7)
    led.check(9, 7)
    e = RetryEntry(ready=1.5, seq=3, rid=7, attempt=2)
    assert e.sort_key() == (1.5, 3) and e.pin_group is None


# ---------------------------------------------------------------------------
# fault scenarios, run against the reference
# ---------------------------------------------------------------------------

def _outage(d, group=1, frac=(0.25, 0.6)):
    return FleetPerturb(failures=(
        ReplicaFailure(group=group, t0=d * frac[0], t1=d * frac[1]),))


def _scenario(name, d):
    """(perturb, recovery, extra fleet kwargs) of one fault scenario on a
    trace of duration ``d``."""
    return {
        "outage": (_outage(d), RecoveryPolicy(max_retries=6), {}),
        "outage_blind": (_outage(d), None, {}),
        "permanent_budget": (
            FleetPerturb(failures=(ReplicaFailure(group=1, t0=d * 0.25),)),
            RecoveryPolicy(max_retries=1, migrate=False, backoff_base=0.05,
                           backoff_cap=0.05), {}),
        "permanent_migrate": (
            FleetPerturb(failures=(ReplicaFailure(group=0, t0=d * 0.2),)),
            RecoveryPolicy(max_retries=6), {}),
        "straggle": (
            FleetPerturb(stragglers=(ReplicaStraggler(
                group=0, factor=4.0, t0=d * 0.1, t1=d * 0.8,
                replicas=(0, 1)),)),
            RecoveryPolicy(max_retries=2, backoff_base=0.05,
                           backoff_cap=0.1), {}),
        "partial_failure": (
            FleetPerturb(failures=(ReplicaFailure(
                group=2, t0=d * 0.1, t1=d * 0.7, replicas=(1, 3)),)),
            None, {}),
        "group_slowdown": (
            FleetPerturb(events=(GroupSlowdown(group=1, factor=5.0,
                                               t0=d * 0.2, t1=d * 0.6),),
                         failures=(ReplicaFailure(group=2, t0=d * 0.3,
                                                  t1=d * 0.5),)),
            RecoveryPolicy(max_retries=6), {}),
        "all_down": (
            FleetPerturb(failures=tuple(
                ReplicaFailure(group=g, t0=d * 0.3, t1=d * 0.6)
                for g in range(3))),
            RecoveryPolicy(max_retries=8), {}),
        "shed": (
            FleetPerturb(failures=tuple(
                ReplicaFailure(group=g, t0=d * 0.2, t1=d * 0.9)
                for g in (0, 1))),
            RecoveryPolicy(max_retries=6, shed_wait=0.2),
            dict(admission=AdmissionControl(wave_quota=64,
                                            queue_depth=0.1))),
        "hedge": (_outage(d, frac=(0.2, 0.7)),
                  RecoveryPolicy(max_retries=6, hedge=True, jitter=0.3), {}),
        "timeout": (_outage(d), RecoveryPolicy(timeout=0.02, max_retries=8),
                    {}),
        "armed_clean": (None, RecoveryPolicy(), {}),
    }[name]


SCENARIOS = ["outage", "outage_blind", "permanent_budget",
             "permanent_migrate", "straggle", "partial_failure",
             "group_slowdown", "all_down", "shed", "hedge", "timeout",
             "armed_clean"]


@pytest.mark.parametrize("router", ["whatif", "least_outstanding"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fault_scenarios_equal_reference(scenario, router):
    trace, jtrace = _traces(1200)
    pert, rec, kw = _scenario(scenario, trace.duration)
    port, ref = _fleets(router=router, perturb=pert, recovery=rec, **kw)
    rep = port.run(trace, keep_latencies=True)
    _same(rep, ref.run(jtrace, keep_latencies=True))
    r = rep.recovery
    assert r["completed"] + r["dead_lettered"] == len(trace)
    assert len(rep.latencies) == r["completed"]
    if scenario == "permanent_budget":
        assert r["dead_lettered"] > 0
    if scenario in ("shed", "hedge", "timeout"):
        key = {"shed": "shed", "hedge": "hedges",
               "timeout": "timeouts"}[scenario]
        assert r[key] > 0


@pytest.mark.parametrize("scenario", ["outage", "hedge", "straggle"])
def test_fault_scenarios_on_the_python_engines(scenario):
    trace, jtrace = _traces(600, seed=11)
    pert, rec, kw = _scenario(scenario, trace.duration)
    port, ref = _fleets("python", perturb=pert, recovery=rec, **kw)
    _same(port.run(trace, keep_latencies=True),
          ref.run(jtrace, keep_latencies=True))


def test_recovery_beats_the_blind_baseline():
    trace, _ = _traces(3000)
    pert = _outage(trace.duration)
    on = _fleets(perturb=pert, recovery=RecoveryPolicy(max_retries=6))[0] \
        .run(trace)
    off = _fleets(perturb=pert, recovery=None)[0].run(trace)
    assert off.recovery["completed"] == len(trace)
    assert on.makespan < off.makespan and on.p95 < off.p95


def test_permanent_failure_unbounded_baseline_raises_like_reference():
    trace, jtrace = _traces(600)
    pert = FleetPerturb(failures=(
        ReplicaFailure(group=0, t0=trace.duration * 0.2),))
    port, ref = _fleets(router="round_robin", perturb=pert, recovery=None)
    with pytest.raises(RuntimeError, match="permanently"):
        port.run(trace)
    with pytest.raises(RuntimeError, match="permanently"):
        ref.run(jtrace)


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------

def test_journal_round_trip_and_retention(tmp_path):
    j = RunJournal(str(tmp_path), keep=2)
    for w in (3, 6, 9):
        j.save(w, {"now": float(w)}, {"x": np.arange(w)})
    assert j.waves() == [6, 9]
    snap = j.load(9)
    assert snap["meta"]["now"] == 9.0 and snap["meta"]["wave"] == 9
    assert np.array_equal(snap["x"], np.arange(9))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # the reference reads the port's snapshots, and the other way round
    other = JJournal(str(tmp_path), keep=0)
    assert other.waves() == [6, 9]
    assert other.load(6)["meta"] == j.load(6)["meta"]
    other.save(12, {"now": 12.0}, {"x": np.ones(3)})
    assert j.load(12)["meta"] == {"now": 12.0, "version": 1, "wave": 12}
    j.clear()
    assert j.waves() == [] and j.latest() is None
    with pytest.raises(ValueError, match="every"):
        RunJournal(str(tmp_path), every=0)


def test_journal_latest_skips_corrupt_and_guards_version(tmp_path):
    j = RunJournal(str(tmp_path), keep=0)
    j.save(1, {"now": 1.0}, {"x": np.ones(2)})
    path = j.save(2, {"now": 2.0}, {"x": np.ones(2)})
    with open(path, "wb") as f:
        f.write(b"torn write")
    with pytest.warns(UserWarning, match="unreadable journal"):
        snap = j.latest()
    assert snap["meta"]["wave"] == 1
    path = j.save(3, {"now": 3.0}, {"x": np.ones(2)})
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        payload = {k: z[k] for k in z.files if k != "meta"}
    meta["version"] = 99
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **payload)
    with pytest.raises(ValueError, match="version"):
        j.load(3)


def _resume_from(tmp_path, src, tag, wave, build, trace, journal_cls):
    d = os.path.join(str(tmp_path), f"resume_{tag}_{wave}")
    os.makedirs(d)
    shutil.copy(os.path.join(src, f"wave_{wave:09d}.npz"), d)
    return build().run(trace, keep_latencies=True,
                       journal=journal_cls(d, every=3, keep=0), resume=True)


@pytest.mark.parametrize("faulty", [False, True])
def test_resume_bit_identical_from_any_wave(tmp_path, faulty):
    trace, jtrace = _traces(1200)
    pert = _outage(trace.duration) if faulty else None
    rec = RecoveryPolicy(max_retries=6, hedge=True) if faulty else None

    def build():
        return _fleets(replicas=3, perturb=pert, recovery=rec)[0]

    full = os.path.join(str(tmp_path), "full")
    ref = build().run(trace, keep_latencies=True,
                      journal=RunJournal(full, every=3, keep=0))
    jref = _fleets(replicas=3, perturb=pert, recovery=rec)[1].run(
        jtrace, keep_latencies=True)
    _same(ref, jref)
    waves = RunJournal(full, every=3, keep=0).waves()
    assert len(waves) >= 3
    for wave in (waves[0], waves[len(waves) // 2], waves[-1]):
        res = _resume_from(tmp_path, full, "p", wave, build, trace,
                           RunJournal)
        assert res.summary() == ref.summary(), f"diverged from wave {wave}"
        assert np.array_equal(res.latencies, ref.latencies)


@pytest.mark.parametrize("router", ["whatif", "round_robin"])
def test_reference_journal_resumes_in_the_port(tmp_path, router):
    """A run the reference journaled, resumed by the port from an early, a
    middle and the last snapshot, ends equal to the reference's
    uninterrupted run: the journal's state (router cursor, region policies,
    queues, ledger) crosses packages."""
    trace, jtrace = _traces(1200)
    pert = _outage(trace.duration)
    rec = RecoveryPolicy(max_retries=6)
    full = os.path.join(str(tmp_path), "full")
    jref = _fleets(router=router, perturb=pert, recovery=rec)[1].run(
        jtrace, keep_latencies=True, journal=JJournal(full, every=3, keep=0))
    waves = JJournal(full, every=3, keep=0).waves()
    assert len(waves) >= 3

    def build():
        return _fleets(router=router, perturb=pert, recovery=rec)[0]

    for wave in (waves[0], waves[len(waves) // 2], waves[-1]):
        res = _resume_from(tmp_path, full, "j", wave, build, trace,
                           RunJournal)
        _same(res, jref)


def test_resume_guards(tmp_path):
    trace, _ = _traces(400)
    j = RunJournal(str(tmp_path), every=2, keep=0)
    _fleets(n_groups=2, replicas=2)[0].run(trace, journal=j)
    with pytest.raises(ValueError, match="cannot resume"):
        _fleets(n_groups=2, replicas=2)[0].run(_traces(400, seed=8)[0],
                                               journal=j, resume=True)
    with pytest.raises(ValueError, match="shape"):
        _fleets(n_groups=3, replicas=2)[0].run(trace, journal=j,
                                               resume=True)
    with pytest.raises(ValueError, match="router"):
        _fleets(n_groups=2, replicas=2, router="round_robin")[0].run(
            trace, journal=j, resume=True)
    with pytest.raises(ValueError, match="no journal"):
        _fleets(n_groups=2, replicas=2)[0].run(
            trace, journal=RunJournal(os.path.join(str(tmp_path), "e")),
            resume=True)
    with pytest.raises(ValueError, match="needs a journal"):
        _fleets(n_groups=2, replicas=2)[0].run(trace, resume=True)


def test_fleet_prices_on_the_card_by_default():
    """With no backend named the fleet resolves the batched engine on the
    card; without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSimulator(n_groups=2, replicas_per_group=2)
    assert FleetSimulator(n_groups=2, replicas_per_group=2,
                          backend="python").backend.name == "python"
