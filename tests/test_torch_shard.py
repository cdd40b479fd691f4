"""The port's campaign mesh, lane split and double-buffered dispatch, on the
CPU against the reference (the cases of ``tests/test_shard.py``).

A list ``[torch.device("cpu")] * d`` stands in for the reference's ``d``
virtual host devices.  Split over d in {1, 2, 3, 8} — lane counts that d
does not divide among them — sweeps, lockstep replays and what-if prices
equal the unsplit port and the reference's JAX batched backend bit for
bit, as do async and sync dispatch.
"""

import json

import numpy as np
import pytest

from repro.distributed.sharding import pad_lanes as j_pad_lanes
from repro.launch.mesh import campaign_mesh as j_campaign_mesh
from repro.sim import CellSpec as JCell
from repro.sim import ReplayBatch as JReplay
from repro.sim import sweep_portfolio as j_sweep
from repro.sim.backends.jax_batched import JaxBatchedBackend

torch = pytest.importorskip("torch")

from repro_torch import TorchBatchedBackend  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    lane_count, lane_spec, pad_lanes, shard_bounds)
from repro_torch.launch.mesh import campaign_mesh, make_host_mesh  # noqa: E402
from repro_torch.sim import CellSpec, ReplayBatch, sweep_portfolio  # noqa: E402
from repro_torch.sim.backends.torch_batched import (  # noqa: E402
    resolve_async_dispatch, resolve_data_parallel)

CPU = torch.device("cpu")
DEVICE_COUNTS = (1, 2, 3, 8)

#: the lockstep lanes of tests/_shard_subproc.py: every selector family,
#: both chunk modes, the reward axis
LANES = [("tc", "epyc", sel, mode, reward)
         for mode in ("default", "expChunk")
         for sel, reward in (("RandomSel", None), ("ExhaustiveSel", None),
                             ("ExpertSel", None), ("QLearn", "LT"),
                             ("QLearn", "LIB"), ("SARSA", "LIB"),
                             ("Hybrid", "LT"))]


def cpus(d):
    return [CPU] * d


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def test_make_host_mesh_rejects_non_divisible_model_parallel():
    with pytest.raises(ValueError, match="not divisible"):
        make_host_mesh(model_parallel=3, devices=cpus(8))
    with pytest.raises(ValueError, match="model_parallel"):
        make_host_mesh(model_parallel=0, devices=cpus(8))


def test_make_host_mesh_data_parallel_clamp():
    # requesting more lanes than devices clamps to what exists; requesting
    # fewer uses exactly that many
    assert len(make_host_mesh(data_parallel=64, devices=cpus(8))) == 8
    m1 = make_host_mesh(data_parallel=1, devices=cpus(8))
    assert len(m1) == 1 and len(m1[0]) == 1
    m = make_host_mesh(model_parallel=2, devices=cpus(8))
    assert [len(row) for row in m] == [2] * 4
    with pytest.raises(ValueError, match="data_parallel"):
        make_host_mesh(data_parallel=0, devices=cpus(8))


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_data_parallel()


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_campaign_mesh_is_data_only(d):
    m = campaign_mesh(devices=cpus(d))
    assert m == cpus(d)
    assert campaign_mesh(data_parallel=2, devices=cpus(d)) == cpus(min(d, 2))


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_lane_padding_helpers(d):
    m = campaign_mesh(devices=cpus(d))
    assert lane_count(m) == d
    assert tuple(lane_spec(m)) == ("data",)
    for n in range(1, 40):
        p = pad_lanes(n, m)
        assert p % d == 0 and n <= p < n + d
        bounds = shard_bounds(p, m)
        assert bounds[0][0] == 0 and bounds[-1][1] == p
        assert all(hi - lo == p // d for lo, hi in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if d > 1:
        with pytest.raises(ValueError, match="split evenly"):
            shard_bounds(d + 1, m)


def test_lane_padding_matches_the_reference_on_one_device():
    jm, m = j_campaign_mesh(data_parallel=1), campaign_mesh(devices=cpus(1))
    assert [pad_lanes(n, m) for n in range(1, 20)] == \
        [j_pad_lanes(n, jm) for n in range(1, 20)]


def test_resolve_data_parallel(monkeypatch):
    monkeypatch.delenv("REPRO_DATA_PARALLEL", raising=False)
    assert resolve_data_parallel(devices=cpus(8)) == 8
    assert resolve_data_parallel(1, devices=cpus(8)) == 1
    assert resolve_data_parallel(10**6, devices=cpus(8)) == 8   # clamp
    monkeypatch.setenv("REPRO_DATA_PARALLEL", "3")
    assert resolve_data_parallel(devices=cpus(8)) == 3
    assert TorchBatchedBackend(devices=cpus(8)).mesh == cpus(3)
    monkeypatch.setenv("REPRO_DATA_PARALLEL", "1")
    assert resolve_data_parallel(devices=cpus(8)) == 1
    with pytest.raises(ValueError):
        resolve_data_parallel(0, devices=cpus(8))


def test_resolve_async_dispatch(monkeypatch):
    monkeypatch.delenv("REPRO_ASYNC_DISPATCH", raising=False)
    assert resolve_async_dispatch() is True
    assert resolve_async_dispatch(False) is False
    assert TorchBatchedBackend(device="cpu").async_dispatch is True
    monkeypatch.setenv("REPRO_ASYNC_DISPATCH", "0")
    assert resolve_async_dispatch() is False
    assert TorchBatchedBackend(device="cpu").async_dispatch is False


def test_backend_devices_default_to_its_device():
    bk = TorchBatchedBackend(device="cpu")
    assert bk.mesh == [CPU] and bk.data_parallel == 1
    bk = TorchBatchedBackend(devices=cpus(3), data_parallel=2)
    assert bk.device == CPU and bk.mesh == cpus(2)


# ---------------------------------------------------------------------------
# async double-buffered dispatch (one device)
# ---------------------------------------------------------------------------

def _same_sweeps(a, b):
    return a.runs.keys() == b.runs.keys() and all(
        np.array_equal(a.runs[k].times, b.runs[k].times)
        and np.array_equal(a.runs[k].libs, b.runs[k].libs)
        for k in a.runs)


def _policy_states(run):
    out = {}
    for nm in run.history:
        policy = run.service.policy(nm)
        state = policy.state_dict()
        if state is None:
            expert = getattr(policy, "_expert", policy)
            state = {"current": getattr(expert, "current", None)}
        out[nm] = json.dumps(state, sort_keys=True, default=str)
    return out


def _same_runs(a, b):
    return len(a) == len(b) and all(
        x.total == y.total and x.history == y.history
        and _policy_states(x) == _policy_states(y) for x, y in zip(a, b))


def test_async_dispatch_bit_equal_single_device():
    sync = TorchBatchedBackend(device="cpu", async_dispatch=False)
    asyn = TorchBatchedBackend(device="cpu", async_dispatch=True)
    s_ref = sweep_portfolio("sphynx", "epyc", T=2, reps=2, backend=sync)
    s_asy = sweep_portfolio("sphynx", "epyc", T=2, reps=2, backend=asyn)
    assert asyn.times.dispatches == sync.times.dispatches > 1
    assert _same_sweeps(s_ref, s_asy)


def test_async_dispatch_bit_equal_lockstep():
    lanes = [CellSpec("tc", "epyc", "QLearn", "default", "LT"),
             CellSpec("tc", "epyc", "ExpertSel", "expChunk", None)]
    runs = {}
    for flag in (False, True):
        bk = TorchBatchedBackend(device="cpu", async_dispatch=flag)
        runs[flag] = ReplayBatch(lanes, T=3, seed=0, backend=bk).run()
    assert _same_runs(runs[False], runs[True])


# ---------------------------------------------------------------------------
# the split over d CPU devices == unsplit == the reference's "jax" backend
# ---------------------------------------------------------------------------

def _what_if_inputs():
    rng = np.random.default_rng(7)
    prefixes = [np.concatenate([[0.0], np.cumsum(rng.random(96 + 31 * i)
                                                 * 1e-3)])
                for i in range(3)]
    avails = [rng.random(8) * 1e-3 for _ in range(3)]
    # 3 slots x 4 algs - 1 = 11 rows: indivisible by 8, 3 and 2 alike
    cands = [(s, a, cp) for s in range(3) for a, cp in
             ((0, 0), (2, 0), (4, 8), (6, 0))][:-1]
    return prefixes, avails, cands


def _run(surface, bk, cell, replay):
    if surface == "run_batch":
        return sweep_portfolio("sphynx", "epyc", T=3, reps=2, backend=bk)
    if surface == "run_lockstep":
        return replay([cell(*x) for x in LANES], T=4, seed=0,
                      backend=bk).run()
    prefixes, avails, cands = _what_if_inputs()
    if surface == "what_if_routes":
        return bk.what_if_routes(prefixes, 8, avails, 2e-4, 1e-3, cands)
    return bk.what_if_wave(prefixes[0], 8, avails[0], 2e-4, 1e-3,
                           list(range(12)))


_REFERENCE = {}


def _reference(surface):
    """The reference's result on its JAX backend, and the unsplit port's
    (one device, synchronous), computed once per surface."""
    if surface not in _REFERENCE:
        if surface == "run_batch":
            jax_res = j_sweep("sphynx", "epyc", T=3, reps=2,
                              backend=JaxBatchedBackend(kernel="while_loop"))
        else:
            jax_res = _run(surface, JaxBatchedBackend(kernel="while_loop"),
                           JCell, JReplay)
        unsplit = _run(surface, TorchBatchedBackend(
            device="cpu", async_dispatch=False), CellSpec, ReplayBatch)
        _REFERENCE[surface] = (jax_res, unsplit)
    return _REFERENCE[surface]


def _equal(surface, a, b):
    if surface == "run_batch":
        return _same_sweeps(a, b)
    if surface == "run_lockstep":
        return _same_runs(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("surface", ["run_batch", "run_lockstep",
                                     "what_if_wave", "what_if_routes"])
@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_split_equals_unsplit_and_reference(surface, d):
    jax_res, unsplit = _reference(surface)
    bk = TorchBatchedBackend(devices=cpus(d))
    assert bk.mesh == cpus(d) and bk.async_dispatch
    got = _run(surface, bk, CellSpec, ReplayBatch)
    assert _equal(surface, got, unsplit)
    assert _equal(surface, got, jax_res)
