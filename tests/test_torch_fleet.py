"""The port's fleet (``repro_torch.serving.fleet``: traces, routers,
admission control and ``FleetSimulator``) against the reference on the CPU.

The port on ``TorchBatchedBackend(device="cpu")`` is held against the
reference on its ``"jax"`` backend, and the port's ``"python"`` engine
against the reference's.  The tolerance is exact everywhere: traces field
for field, shards request for request, summaries with ``==`` and
latencies with ``np.array_equal``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import AdmissionControl as JAdmission  # noqa: E402
from repro.serving import FleetSimulator as JFleet  # noqa: E402
from repro.serving import FleetView as JView  # noqa: E402
from repro.serving import ReplicaCostModel as JCost  # noqa: E402
from repro.serving import make_router as j_make_router  # noqa: E402
from repro.serving import make_trace as j_make_trace  # noqa: E402
from repro.sim.backends import get_backend as j_get_backend  # noqa: E402
from repro.sim.perturb import FleetPerturb as JPerturb  # noqa: E402
from repro.sim.perturb import GroupSlowdown as JSlowdown  # noqa: E402
from repro_torch import TorchBatchedBackend  # noqa: E402
from repro_torch.data import synthetic_requests  # noqa: E402
from repro_torch.serving import (AdmissionControl, FleetSimulator,  # noqa: E402
                                 FleetView, LeastOutstandingRouter,
                                 ReplicaCostModel, RoundRobinRouter,
                                 WhatIfRouter, make_router, make_trace)
from repro_torch.serving.fleet import ROUTERS, TRACE_KINDS  # noqa: E402
from repro_torch.sim import FleetPerturb, GroupSlowdown  # noqa: E402
from repro_torch.sim.backends import get_backend  # noqa: E402

TORCH = TorchBatchedBackend(device="cpu")
BURSTY = dict(base_rate=2000.0, burst_factor=6.0, p_enter=0.015, p_exit=0.05)
#: one regime of each trace kind near the fleet benchmark's rates
TRACES = {"poisson": dict(rate=2400.0), "bursty": BURSTY,
          "diurnal": dict(base_rate=2000.0, amplitude=0.8, period=0.4)}


def _rows(requests):
    return [dataclasses.astuple(r) for r in requests]


def _rids(shards):
    return [[r.rid for r in s] for s in shards]


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(TRACE_KINDS))
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n", [1, 500, 3000])
def test_traces_equal_reference(kind, seed, n):
    got = make_trace(kind, n, seed=seed, **TRACES[kind])
    want = j_make_trace(kind, n, seed=seed, **TRACES[kind])
    assert (got.kind, got.seed, got.params) == \
        (want.kind, want.seed, want.params)
    assert _rows(got.requests) == _rows(want.requests)
    assert got.signature == want.signature
    assert got.duration == want.duration
    assert got.mean_rate == want.mean_rate
    assert got.offered_tokens() == want.offered_tokens()
    assert len(got) == n


@pytest.mark.parametrize("kind", sorted(TRACE_KINDS))
def test_trace_defaults_and_length_params_equal_reference(kind):
    got = make_trace(kind, 400, seed=3, mean_prompt=64, heavy_tail=1.8)
    want = j_make_trace(kind, 400, seed=3, mean_prompt=64, heavy_tail=1.8)
    assert _rows(got.requests) == _rows(want.requests)
    assert got.signature == want.signature


def test_trace_errors_match_reference():
    with pytest.raises(ValueError, match="unknown trace kind"):
        make_trace("fractal", 10)
    with pytest.raises(ValueError, match="amplitude"):
        make_trace("diurnal", 10, amplitude=1.0)


# ---------------------------------------------------------------------------
# routers on the same fleet views
# ---------------------------------------------------------------------------

def _views(busy, R=4, capacity=None, routable=None, engine="torch"):
    pb, jb = {"torch": (TORCH, "jax"),
              "python": ("python", "python")}[engine]
    busy = [np.asarray(b, dtype=float) for b in busy]
    kw = dict(now=0.0, n_replicas=R, h=0.2e-3, capacity=capacity,
              routable=routable)
    return (FleetView(busy=busy, cost=ReplicaCostModel(),
                      backend=get_backend(pb), **kw),
            JView(busy=[b.copy() for b in busy], cost=JCost(),
                  backend=j_get_backend(jb), **kw))


def _busy_states(G, R, seed):
    rng = np.random.default_rng(seed)
    return [
        [np.zeros(R)] * G,
        [rng.random(R) * 0.05 for _ in range(G)],
        [np.full(R, 0.4)] + [rng.random(R) * 0.01 for _ in range(G - 1)],
    ]


VIEW_CASES = [
    dict(),
    dict(capacity=np.array([1.0, 0.25, 0.6])),
    dict(routable=np.array([True, False, True])),
    dict(capacity=np.array([0.5, 1.0, 0.0]),
         routable=np.array([True, True, False])),
    dict(routable=np.array([True, True, True])),
]


@pytest.mark.parametrize("router", ["round_robin", "least_outstanding",
                                    "whatif"])
@pytest.mark.parametrize("case", range(len(VIEW_CASES)))
def test_routers_shard_like_the_reference(router, case):
    port, ref = make_router(router), j_make_router(router)
    for w, busy in enumerate(_busy_states(3, 4, seed=case)):
        view, jview = _views(busy, **VIEW_CASES[case])
        n = (5, 40, 97)[w]
        shards = port.route(synthetic_requests(n, seed=w), view)
        jshards = ref.route(synthetic_requests(n, seed=w), jview)
        assert _rids(shards) == _rids(jshards)
        assert sorted(r.rid for s in shards for r in s) == list(range(n))
        routable = VIEW_CASES[case].get("routable")
        if routable is not None:
            assert all(not shards[g] for g in np.flatnonzero(~routable))
        assert port.state_dict() == ref.state_dict()
    if router == "whatif":
        assert port.last_prices == ref.last_prices
        assert port.choices == ref.choices
        assert set(port.last_prices) == {"stripe", "lpt", "waterfill",
                                         "focus"}


@pytest.mark.parametrize("engine", ["torch", "python"])
@pytest.mark.parametrize("kw", [dict(), dict(algs=range(12)),
                                dict(chunk_variants=False),
                                dict(algs=(1, 3))])
def test_whatif_router_prices_equal_reference(engine, kw):
    port, ref = WhatIfRouter(**kw), j_make_router("whatif", **kw)
    busy = _busy_states(4, 8, seed=9)[1]
    for n in (1, 9, 64, 300):
        view, jview = _views(busy, R=8, engine=engine)
        got = port.route(synthetic_requests(n, seed=n), view)
        want = ref.route(synthetic_requests(n, seed=n), jview)
        assert _rids(got) == _rids(want)
        if n > 1:
            assert port.last_prices == ref.last_prices
    assert port.choices == ref.choices
    assert port.choices[-1] == min(port.last_prices,
                                   key=port.last_prices.get)


def test_round_robin_cursor_state_round_trip():
    rr = RoundRobinRouter()
    view, _ = _views([np.zeros(4)] * 3)
    reqs = synthetic_requests(8, seed=0)
    assert _rids(rr.route(reqs[:4], view)) == [[0, 3], [1], [2]]
    state = rr.state_dict()
    assert state == {"cursor": 1}
    twin = RoundRobinRouter()
    twin.load_state_dict(state)
    assert _rids(twin.route(reqs[4:], view)) == \
        _rids(rr.route(reqs[4:], view)) == [[6], [4, 7], [5]]
    twin.load_state_dict({})
    assert twin.state_dict() == {"cursor": 0}


def test_router_registry_equals_reference():
    from repro.serving.fleet import ROUTERS as J_ROUTERS
    assert {k: v.name for k, v in ROUTERS.items()} == \
        {k: v.name for k, v in J_ROUTERS.items()}
    assert isinstance(make_router(None), WhatIfRouter)
    assert isinstance(make_router("LOR"), LeastOutstandingRouter)
    inst = RoundRobinRouter()
    assert make_router(inst) is inst
    with pytest.raises(ValueError, match="unknown router"):
        make_router("hash_ring")
    assert WhatIfRouter.PRICING_ALGS == (0, 2, 4, 6)


def test_fleet_view_prefix_and_route_prices_equal_reference():
    view, jview = _views(_busy_states(3, 4, seed=2)[1])
    reqs = synthetic_requests(33, seed=4)
    assert np.array_equal(view.cost_prefix(reqs), jview.cost_prefix(reqs))
    prefixes = [view.cost_prefix(reqs[a:b]) for a, b in
                ((0, 10), (10, 33), (5, 5))]
    cands = [(s, a, cp) for s in range(3) for a in (0, 2, 5, 6)
             for cp in (0, 3)]
    got = view.price_routes(prefixes, view.busy, cands)
    want = jview.price_routes(prefixes, jview.busy, cands)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

ADMISSIONS = [
    dict(wave_quota=128),
    dict(wave_quota=128, queue_depth=0.1, min_admit=8),
    dict(wave_quota=128, queue_depth=1e-12, min_admit=8),
    dict(wave_quota=256, p95_slo=0.1, min_admit=8),
    dict(wave_quota=256, p95_slo=0.02, min_admit=8),
    dict(wave_quota=4, p95_slo=1e-6, min_admit=1),
]


@pytest.mark.parametrize("case", range(len(ADMISSIONS)))
def test_admission_equals_reference(case):
    ac, jac = AdmissionControl(**ADMISSIONS[case]), \
        JAdmission(**ADMISSIONS[case])
    reqs = synthetic_requests(600, seed=0, arrival_rate=1e4)
    for busy in ([np.zeros(4)] * 2, [np.full(4, 5.0)] * 2,
                 [np.linspace(0, 0.05, 4), np.zeros(4)]):
        for capacity in (None, np.ones(2), np.array([1.0, 0.1])):
            view, jview = _views(busy, capacity=capacity)
            for head, now in ((600, 0.05), (10, 1.0), (0, 1.0)):
                k = ac.admit(reqs[:head], now, view)
                assert k == jac.admit(reqs[:head], now, jview)
                assert 0 <= k <= head


# ---------------------------------------------------------------------------
# FleetSimulator runs
# ---------------------------------------------------------------------------

def _fleets(engine="torch", **kw):
    pb, jb = {"torch": (TORCH, "jax"),
              "python": ("python", "python")}[engine]
    jkw = dict(kw)
    if "perturb" in jkw:
        jkw["perturb"] = JPerturb(events=tuple(
            JSlowdown(**dataclasses.asdict(e)) for e in kw["perturb"].events))
    if "admission" in jkw:
        jkw["admission"] = JAdmission(**dataclasses.asdict(kw["admission"]))
    return FleetSimulator(backend=pb, **kw), JFleet(backend=jb, **jkw)


def _same_runs(fleet, jfleet, kind, n, seed=0, **params):
    params = {**TRACES[kind], **params}
    rep = fleet.run(make_trace(kind, n, seed=seed, **params),
                    keep_latencies=True)
    jrep = jfleet.run(j_make_trace(kind, n, seed=seed, **params),
                      keep_latencies=True)
    assert rep.summary() == jrep.summary()
    assert np.array_equal(rep.latencies, jrep.latencies)
    assert rep.per_group == jrep.per_group
    for sim, jsim in zip(fleet.groups, jfleet.groups):
        assert [dataclasses.astuple(s) for s in sim.stats] == \
            [dataclasses.astuple(s) for s in jsim.stats]
    if isinstance(fleet.router, WhatIfRouter):
        assert fleet.router.choices == jfleet.router.choices
    return rep


@pytest.mark.parametrize("kind", sorted(TRACES))
@pytest.mark.parametrize("router", ["round_robin", "least_outstanding",
                                    "whatif"])
def test_fleet_runs_equal_reference(router, kind):
    fleet, jfleet = _fleets(n_groups=3, replicas_per_group=4, router=router,
                            selector="SimPolicy", seed=0)
    rep = _same_runs(fleet, jfleet, kind, 2000)
    assert rep.n_requests == 2000
    assert sum(g["requests"] for g in rep.per_group) == 2000


@pytest.mark.parametrize("router", ["round_robin", "whatif"])
def test_fleet_golden_regime_cut_equals_reference(router):
    """A 6,000-request cut of the fleet benchmark's tier-1 bursty regime
    (4 x 8 replicas, ``wave_quota`` 1024, SimPolicy groups)."""
    fleet, jfleet = _fleets(n_groups=4, replicas_per_group=8, router=router,
                            selector="SimPolicy",
                            admission=AdmissionControl(wave_quota=1024))
    rep = _same_runs(fleet, jfleet, "bursty", 6000)
    assert rep.waves == 51


@pytest.mark.parametrize("selector,router", [
    ("QLearn", "whatif"), ("ExpertSel", "least_outstanding"),
    ("SimHybrid", "whatif")])
def test_fleet_selectors_and_python_engine_equal_reference(selector, router):
    fleet, jfleet = _fleets("python", n_groups=2, replicas_per_group=4,
                            router=router, selector=selector, seed=5)
    _same_runs(fleet, jfleet, "bursty", 800, seed=2)


def test_fleet_slowdowns_and_backpressure_equal_reference():
    """A persistent per-group slowdown composed with a windowed
    ``GroupSlowdown``, under queue-depth backpressure that holds waves."""
    pz = FleetPerturb(events=(GroupSlowdown(group=0, factor=6.0, t0=0.1,
                                            t1=0.5),))
    fleet, jfleet = _fleets(n_groups=3, replicas_per_group=4,
                            router="whatif", selector="SimPolicy",
                            group_slowdown=[1.0, 1.5, 1.0], perturb=pz,
                            admission=AdmissionControl(
                                wave_quota=64, queue_depth=0.02,
                                min_admit=8))
    rep = _same_runs(fleet, jfleet, "poisson", 1500)
    assert rep.deferred > 0


def test_fleet_validates_and_is_single_shot():
    with pytest.raises(ValueError, match="group_slowdown"):
        FleetSimulator(n_groups=3, backend=TORCH, group_slowdown=[1.0, 2.0])
    fleet = FleetSimulator(n_groups=2, replicas_per_group=2, backend=TORCH)
    trace = make_trace("poisson", 50, seed=0)
    fleet.run(trace)
    with pytest.raises(RuntimeError, match="single-shot"):
        fleet.run(trace)


def test_fleet_warm_starts_from_a_reference_store(tmp_path):
    """Region snapshots that the reference's fleet wrote warm-start the
    port's, and the warm-started runs stay equal."""
    store = str(tmp_path / "store")
    kw = dict(n_groups=2, replicas_per_group=4, router="rr",
              selector="Hybrid", seed=3,
              selector_kw=dict(expert_steps=2, window=2), store_dir=store)
    adm = dict(wave_quota=16)
    trace_kw = dict(rate=800.0)
    writer = JFleet(admission=JAdmission(**adm), backend="jax", **kw)
    writer.run(j_make_trace("poisson", 600, seed=0, **trace_kw))
    assert len(writer.save_state()) == 2
    fleet = FleetSimulator(admission=AdmissionControl(**adm), backend=TORCH,
                           **kw)
    jfleet = JFleet(admission=JAdmission(**adm), backend="jax", **kw)
    assert fleet.warm_started() == jfleet.warm_started() == [True, True]
    rep = fleet.run(make_trace("poisson", 600, seed=1, **trace_kw),
                    keep_latencies=True)
    jrep = jfleet.run(j_make_trace("poisson", 600, seed=1, **trace_kw),
                      keep_latencies=True)
    assert rep.summary() == jrep.summary()
    assert np.array_equal(rep.latencies, jrep.latencies)
    wider = FleetSimulator(**{**kw, "n_groups": 3}, backend=TORCH)
    assert wider.warm_started() == [True, True, False]
