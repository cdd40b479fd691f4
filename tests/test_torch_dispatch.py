"""The port's serving dispatcher (``repro_torch.serving.engine``:
``DispatchSimulator``, ``WaveWhatIf``, ``WaveStats``) and the dispatch
half of ``repro_torch.launch.serve`` against the reference on the CPU.

The port on ``TorchBatchedBackend(device="cpu")`` is held against the
reference on its ``"jax"`` backend, and the port's ``"python"`` engine
against the reference's.  The tolerance is exact everywhere: wave
statistics, summaries and busy offsets are equal bit for bit, because the
self-scheduling loop is the reference's float64 host loop and the
what-if prices that steer the simulation-assisted selectors are bit-equal
(``tests/test_torch_backend.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.simpolicy import Candidate as JCandidate  # noqa: E402
from repro.data import synthetic_requests as j_requests  # noqa: E402
from repro.serving import DispatchSimulator as JDispatch  # noqa: E402
from repro.serving import ReplicaCostModel as JCost  # noqa: E402
from repro.serving.engine import WaveWhatIf as JWaveWhatIf  # noqa: E402
from repro_torch import TorchBatchedBackend  # noqa: E402
from repro_torch.core.simpolicy import Candidate, SimUnavailable  # noqa: E402
from repro_torch.data import synthetic_requests  # noqa: E402
from repro_torch.launch.serve import dispatch  # noqa: E402
from repro_torch.serving import (DispatchSimulator, ReplicaCostModel,  # noqa: E402
                                 WaveStats, WaveWhatIf)

TORCH = TorchBatchedBackend(device="cpu")
#: (port backend, reference backend) pairs held against each other
ENGINES = {"torch": (TORCH, "jax"), "python": ("python", "python")}
SELECTORS = ["QLearn", "ExpertSel", "Hybrid", "SimPolicy", "SimHybrid"]


def _pair(engine, R=8, selector="QLearn", **kw):
    pb, jb = ENGINES[engine]
    port = DispatchSimulator(R, selector=selector, backend=pb, **kw)
    ref = JDispatch(R, selector=selector, backend=jb,
                    **{k: (JCost(**dataclasses.asdict(v))
                           if isinstance(v, ReplicaCostModel) else v)
                       for k, v in kw.items()})
    return port, ref


def _stats(stats):
    return [dataclasses.astuple(s) for s in stats]


@pytest.mark.parametrize("selector,engine", [
    *((s, "torch") for s in SELECTORS), ("QLearn", "python"),
    ("SimPolicy", "python")])
def test_run_wave_for_wave_equals_reference(selector, engine):
    port, ref = _pair(engine, selector=selector, seed=3,
                      cost_model=ReplicaCostModel(per_token=4e-6))
    got = port.run(synthetic_requests(640, seed=11, heavy_tail=1.15),
                   wave_size=64)
    want = ref.run(j_requests(640, seed=11, heavy_tail=1.15), wave_size=64)
    assert all(isinstance(s, WaveStats) for s in got)
    assert _stats(got) == _stats(want)
    assert port.summary() == ref.summary()
    assert np.array_equal(port.busy, ref.busy)
    assert port.summary()["waves"] == 10


@pytest.mark.parametrize("selector", ["QLearn", "SimPolicy"])
def test_active_masks_and_replica_scale_equal_reference(selector):
    """Masked waves (their what-if pricing routes around the dead
    replicas too) and straggler scales, wave for wave."""
    port, ref = _pair("torch", R=6, selector=selector, seed=1)
    rng = np.random.default_rng(5)
    reqs = synthetic_requests(480, seed=2)
    jreqs = j_requests(480, seed=2)
    for w in range(8):
        active = rng.random(6) > 0.3
        active[w % 6] = True
        scale = np.where(rng.random(6) > 0.5, 1.0 + 3.0 * rng.random(6), 1.0)
        if w == 3:
            active[:] = True            # the all-active clean path
        if w == 5:
            scale = np.ones(6)
        sl = slice(60 * w, 60 * (w + 1))
        a = port.run_wave(reqs[sl], w, active=active, replica_scale=scale)
        b = ref.run_wave(jreqs[sl], w, active=active, replica_scale=scale)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert np.array_equal(port.busy, ref.busy)


def test_all_active_mask_and_unit_scale_are_the_clean_path():
    reqs = synthetic_requests(200, seed=4)
    clean = DispatchSimulator(4, selector="SimPolicy", backend=TORCH)
    masked = DispatchSimulator(4, selector="SimPolicy", backend=TORCH)
    a = clean.run_wave(reqs)
    b = masked.run_wave(reqs, active=np.ones(4, bool),
                        replica_scale=np.ones(4))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert np.array_equal(clean.busy, masked.busy)


def test_run_wave_validates_masks_and_scales():
    sim = DispatchSimulator(4, selector="Fixed",
                            selector_kw={"algorithm": 1})
    reqs = synthetic_requests(16, seed=0)
    with pytest.raises(ValueError, match="active mask"):
        sim.run_wave(reqs, active=np.ones(3, bool))
    with pytest.raises(ValueError, match="at least one active"):
        sim.run_wave(reqs, active=np.zeros(4, bool))
    with pytest.raises(ValueError, match="replica_scale"):
        sim.run_wave(reqs, replica_scale=np.ones(5))
    assert sim.stats == []


def test_busy_setter_copies_and_validates():
    port, ref = _pair("torch", R=4, selector="Fixed",
                      selector_kw={"algorithm": 1})
    offsets = np.array([0.0, 1.0, 2.0, 3.0])
    port.busy = offsets
    ref.busy = offsets
    got = port.busy
    assert np.array_equal(got, ref.busy)
    got[0] = 99.0                       # the property hands out a copy
    offsets[1] = 99.0                   # and the setter took one
    assert port.busy[0] == 0.0 and port.busy[1] == 1.0
    for bad in (np.zeros(3), np.zeros((4, 1))):
        with pytest.raises(ValueError, match="busy offsets"):
            port.busy = bad
    a = port.run_wave(synthetic_requests(64, seed=1))
    b = ref.run_wave(j_requests(64, seed=1))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert np.array_equal(port.busy, ref.busy)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("chunk_param", [0, 4])
def test_wave_whatif_candidates_and_prices_equal_reference(engine,
                                                           chunk_param):
    port, ref = _pair(engine, R=4, selector="Fixed",
                      selector_kw={"algorithm": 1}, chunk_param=chunk_param)
    w, jw = WaveWhatIf(port), JWaveWhatIf(ref)
    with pytest.raises(SimUnavailable):
        w.candidates()
    with pytest.raises(SimUnavailable):
        w.price([Candidate(0)])
    reqs, jreqs = synthetic_requests(48, seed=3), j_requests(48, seed=3)
    w.set_requests(reqs)
    jw.set_requests(jreqs)
    cands = w.candidates()
    assert [(c.alg, c.chunk_param) for c in cands] == \
        [(c.alg, c.chunk_param) for c in jw.candidates()]
    for busy in (np.zeros(4), np.array([0.0, 0.05, 0.1, 0.2])):
        port.busy = busy
        ref.busy = busy
        got = [o.loop_time for o in w.price(cands)]
        want = [o.loop_time for o in jw.price(
            [JCandidate(c.alg, c.chunk_param) for c in cands])]
        assert got == want
    mixed = [Candidate(0), Candidate(2, 4), Candidate(6), Candidate(4, 4)]
    got = [o.loop_time for o in w.price(mixed)]
    by_cp = {cp: port.what_if(reqs, algs=[c.alg for c in mixed
                                          if c.chunk_param == cp],
                              chunk_param=cp) for cp in (None, 4)}
    assert got == [by_cp[None][0], by_cp[4][0], by_cp[None][1],
                   by_cp[4][1]]


def test_dispatch_region_names_the_service_region():
    sim = DispatchSimulator(2, selector="Fixed",
                            selector_kw={"algorithm": 0}, region="regionX")
    sim.run_wave(synthetic_requests(8, seed=0))
    assert sim.service.regions == ["regionX"]
    assert DispatchSimulator(2).region == "dispatch"


@pytest.mark.parametrize("selector,engine", [
    ("QLearn", None), ("ExpertSel", None), ("SimPolicy", "torch"),
    ("SimPolicy", "python")])
@pytest.mark.parametrize("per_tok", [2.5e-4, 1.1e-3])
def test_launch_dispatch_equals_reference(selector, engine, per_tok):
    """``launch.serve.dispatch`` against the reference's
    ``DispatchSimulator`` built as its ``launch/serve.py`` builds it."""
    pb, jb = ENGINES[engine] if engine else (None, None)
    summary, shares = dispatch(per_tok, selector=selector, backend=pb)
    reqs = j_requests(2048, seed=7, heavy_tail=1.15)
    sim = JDispatch(16, selector=selector, reward="LT",
                    cost_model=JCost(per_token=per_tok / 50), backend=jb)
    sim.run(reqs)
    want = {}
    for st in sim.stats:
        want[st.algorithm] = want.get(st.algorithm, 0) + 1
    assert summary == sim.summary()
    assert shares == want
    assert sum(shares.values()) == summary["waves"] == 8


def test_launch_dispatch_prices_on_the_card_by_default():
    """With no backend named, a simulation-assisted dispatch prices on the
    card, so without one it raises; QLearn never prices."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch(1e-3, requests=64, selector="SimPolicy")
    summary, _ = dispatch(1e-3, requests=64)
    assert summary["waves"] == 1
