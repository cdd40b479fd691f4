"""The port's selector replays against the reference's, on the CPU: the
lockstep ``ReplayBatch``, ``run_selector``, ``run_campaign`` (Fig. 5),
``LoopWhatIf`` pricing and ``TransitionLogger`` logs of ``repro_torch.sim``
equal those of ``repro.sim`` on the JAX batched backend, bit for bit —
histories, totals, Q-tables and the expert ladder's position — and in the
port the lockstep replay equals the sequential one, on clean, perturbed
and heterogeneous lanes alike."""

import dataclasses
import inspect

import numpy as np
import pytest

from repro.sim import CellSpec as JCell
from repro.sim import ReplayBatch as JReplay
from repro.sim import TransitionLogger as JLog
from repro.sim import campaign as JC
from repro.sim.backends import InstanceSpec as JSpec
from repro.sim.backends.jax_batched import JaxBatchedBackend
from repro.sim.perturb import pe_slowdown_spec
from repro.sim.whatif import LoopWhatIf as JWhatIf
import repro.core.learned as JL

torch = pytest.importorskip("torch")

import repro_torch.core.learned as PL  # noqa: E402
from repro_torch import TorchBatchedBackend  # noqa: E402
from repro_torch.core import OraclePolicy, SimPolicy  # noqa: E402
from repro_torch.sim import CellSpec as PCell  # noqa: E402
from repro_torch.sim import HETERO_SYSTEMS  # noqa: E402
from repro_torch.sim import ReplayBatch as PReplay  # noqa: E402
from repro_torch.sim import TransitionLogger as PLog  # noqa: E402
from repro_torch.sim import campaign as PC  # noqa: E402
from repro_torch.sim import (get_application, get_backend,  # noqa: E402
                             get_system, load_translog)
from repro_torch.sim.backends import InstanceSpec as PSpec  # noqa: E402
from repro_torch.sim.perturb import (  # noqa: E402
    pe_slowdown_spec as P_pe_slowdown_spec)
from repro_torch.sim.whatif import LoopWhatIf, noise_free  # noqa: E402

JAX = JaxBatchedBackend(kernel="while_loop")
TORCH = TorchBatchedBackend(device="cpu")

#: the T = 4 grid of tests/test_replay.py: two cells on two machine models
#: in one batch, every selector family, both chunk modes, the reward axis
GRID = [(app, system, sel, mode, reward)
        for app, system in (("mandelbrot", "broadwell"), ("tc", "epyc"))
        for mode in ("default", "expChunk")
        for sel, reward in (("RandomSel", None), ("ExhaustiveSel", None),
                            ("ExpertSel", None), ("QLearn", "LT"),
                            ("QLearn", "LIB"), ("SARSA", "LIB"),
                            ("Hybrid", "LT"))]
#: the simulation-assisted lanes of tests/test_simpolicy.py
SIM_LANES = [("mandelbrot", "broadwell", sel, "default", "LT")
             for sel in ("SimPolicy", "SimHybrid", "QLearn")]
LEARNED_LANES = [(app, system, sel, mode, reward)
                 for app, system in (("mandelbrot", "broadwell"),
                                     ("tc", "epyc"))
                 for mode in ("default", "expChunk")
                 for sel, reward in (("Learned", "LT"),
                                     ("LearnedHybrid", "LT"),
                                     ("LearnedHybrid", "LIB"))]


def policy_states(run):
    """Comparable per-loop policy state: ``state_dict`` where there is one,
    the expert ladder's position where there is none (as
    ``tests/test_replay.py`` compares them)."""
    out = {}
    for nm in run.history:
        policy = run.service.policy(nm)
        state = policy.state_dict()
        if state is None:
            expert = getattr(policy, "_expert", policy)
            state = {"current": getattr(expert, "current", None)}
        out[nm] = state
    return out


def assert_runs_equal(got, want, spec=None):
    assert got.history == want.history, spec
    assert got.total == want.total, spec
    assert policy_states(got) == policy_states(want), spec


def both(lanes, T, **kw):
    ref = JReplay([JCell(*c) for c in lanes], T=T, backend=JAX, **kw).run()
    port = PReplay([PCell(*c) for c in lanes], T=T, backend=TORCH,
                   **kw).run()
    return ref, port


def learned_state(seed=3, hidden=16):
    rng = np.random.default_rng(seed)
    shapes = {"w0": (JL.N_FEATURES, hidden), "b0": (hidden,),
              "w1": (hidden, hidden), "b1": (hidden,),
              "w2": (hidden, 12), "b2": (12,)}
    return JL.make_learned_state({k: (0.5 * rng.standard_normal(s)).astype(
        np.float32) for k, s in shapes.items()})


@pytest.fixture
def learned_default():
    state = learned_state()
    JL.set_default_state(state)
    PL.set_default_state(state)
    yield state
    JL.set_default_state(None)
    PL.set_default_state(None)


def test_lockstep_grid_bit_equal_to_reference():
    ref, port = both(GRID + SIM_LANES, T=4)
    for spec, a, b in zip(GRID + SIM_LANES, port, ref):
        assert_runs_equal(a, b, spec)


def test_learned_lanes_bit_equal_to_reference(learned_default):
    ref, port = both(LEARNED_LANES, T=4)
    for spec, a, b in zip(LEARNED_LANES, port, ref):
        assert_runs_equal(a, b, spec)
        # the nets scored: the learned lanes' first decisions are the net's
        if spec[2] == "Learned":
            assert a.service.policy("L0").trained


@pytest.mark.parametrize("lanes", [GRID[:7] + GRID[21:], SIM_LANES],
                         ids=["grid", "sim"])
def test_lockstep_equals_sequential_in_the_port(lanes):
    runs = PReplay([PCell(*c) for c in lanes], T=3, backend=TORCH).run()
    for c, run in zip(lanes, runs):
        ref = PC.run_selector_sequential(
            c[0], c[1], c[2], chunk_mode=c[3], reward=c[4], T=3,
            backend=TORCH)
        assert_runs_equal(run, ref, c)


def test_run_selector_is_a_one_lane_replay():
    r = PC.run_selector("sphynx", "cascadelake", "ExhaustiveSel", T=5,
                        backend=TORCH)
    j = JC.run_selector("sphynx", "cascadelake", "ExhaustiveSel", T=5,
                        backend=JAX)
    assert_runs_equal(r, j)
    seq = PC.run_selector_sequential("sphynx", "cascadelake",
                                     "ExhaustiveSel", T=5, backend=TORCH)
    assert_runs_equal(r, seq)
    shares = r.selection_shares()
    assert shares == j.selection_shares() and abs(sum(shares.values())
                                                  - 1.0) < 1e-12


def test_run_campaign_fig5_bit_equal_to_reference():
    kw = dict(T=4, reps=1, selectors=PC.SIM_SELECTOR_GRID)
    port = PC.run_campaign([("tc", "epyc")], backend=TORCH, **kw)
    ref = JC.run_campaign([("tc", "epyc")], backend=JAX, **kw)
    p, j = port[("tc", "epyc")], ref[("tc", "epyc")]
    assert p.oracle_total == j.oracle_total
    assert p.sweep.cov() == j.sweep.cov()
    assert p.degradation() == j.degradation()
    assert set(p.selector_runs) == set(j.selector_runs) and \
        len(p.selector_runs) == 22
    for key, run in p.selector_runs.items():
        assert_runs_equal(run, j.selector_runs[key], key)
    assert set(p.walls) == {"sweep_s", "replay_s"}
    # one cell through run_campaign_cell gives the same table
    cell = PC.run_campaign_cell("tc", "epyc", backend=TORCH,
                                selector_backend=TORCH,
                                selectors=PC.SELECTOR_GRID[:3], T=4, reps=1)
    assert cell.degradation() == {
        k: v for k, v in p.degradation().items() if k[0] in (
            "RandomSel", "ExhaustiveSel", "ExpertSel")}
    assert PC.SIM_SELECTOR_GRID == JC.SIM_SELECTOR_GRID
    assert PC.EXTENDED_SELECTOR_GRID == JC.EXTENDED_SELECTOR_GRID


def test_oracle_lane_follows_the_sweep():
    sweep = PC.sweep_portfolio("tc", "epyc", T=3, reps=1, backend=TORCH)
    r = PC.run_selector("tc", "epyc", "Oracle", T=3, sweep=sweep,
                        backend=TORCH)
    best = sweep.oracle_best_fn(0)
    assert [a for a, _, _ in r.history["L0"]] == [best(t) for t in range(3)]


def test_lane_seeds_bit_equal_to_reference():
    for label in ("mandelbrot", "QLearn", "QLearn+LIB", "expChunk", ""):
        assert PC._digest(label) == JC._digest(label)
    for sel, reward in PC.SIM_SELECTOR_GRID + [("Learned", None)]:
        assert PC._lane_digest(sel, reward) == JC._lane_digest(sel, reward)
        for mode in PC.CHUNK_MODES:
            a = PC._lane_rng("tc", get_system("epyc"), sel, mode, reward, 7)
            b = JC._lane_rng("tc", JC.get_system("epyc"), sel, mode, reward,
                             7)
            assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("seed", [(0x51A5, 3, 0), (0x51A5, 11, 1024),
                                  (0x51A5, 0, 2**20), (0x51A5,)])
def test_pricing_seed_folds_as_the_reference(seed):
    assert PSpec(0, 0, 0, seed).fold_seed() == JSpec(0, 0, 0, seed).fold_seed()


def _oracle_choice(profile, system, candidates):
    """Exhaustive Oracle on the noise-free system, with seeds of its own
    (independent of ``LoopWhatIf``'s), as ``tests/test_simpolicy.py``."""
    specs = [PSpec(profile_id=0, alg=c.alg,
                   chunk_param=0 if c.chunk_param is None else c.chunk_param,
                   seed=(7, i)) for i, c in enumerate(candidates)]
    res = TORCH.run_batch([profile], noise_free(system), specs)
    best = int(np.argmin(res.loop_time))
    oracle = OraclePolicy(lambda t: candidates[best].alg)
    return oracle.decide().action, candidates[best], res.loop_time


def test_whatif_argmin_is_the_oracle_and_prices_match_reference():
    profile = get_application("tc").loops(0)[0]
    system = get_system("epyc")
    whatif = LoopWhatIf(system, backend=TORCH)
    whatif.set_context(profile, 0)
    cands = whatif.candidates()
    action, cand, times = _oracle_choice(profile, system, cands)
    d = SimPolicy(whatif, reward="LT").decide()
    assert d.phase == "exploit"
    assert (d.action, d.chunk_param) == (action, cand.chunk_param)
    spread = np.partition(times, 1)
    assert (spread[1] - spread[0]) / spread[0] > 0.2
    # the prices themselves equal the reference's, and come from the cache
    jw = JWhatIf(JC.get_system("epyc"), backend=JAX)
    jw.set_context(JC.get_application("tc").loops(0)[0], 0)
    jc = jw.candidates()
    assert [(c.alg, c.chunk_param) for c in cands] == \
        [(c.alg, c.chunk_param) for c in jc]
    got = whatif.price(cands)
    assert [vars(o) for o in got] == [vars(o) for o in jw.price(jc)]
    assert whatif.price(cands) is got
    assert (whatif.calls, whatif.misses) == (3, 1) and whatif.wall_s > 0


def test_translog_arrays_bit_equal_to_reference(tmp_path):
    lanes = [("mandelbrot", "broadwell", "QLearn", "default", "LT"),
             ("mandelbrot", "broadwell", "SimPolicy", "expChunk", "LT"),
             ("tc", "epyc", "ExpertSel", "default", None)]
    jl, pl = JLog(sim_backend=JAX), PLog(sim_backend=TORCH)
    ref, port = (JReplay([JCell(*c) for c in lanes], T=3, backend=JAX,
                         translog=jl).run(),
                 PReplay([PCell(*c) for c in lanes], T=3, backend=TORCH,
                         translog=pl).run())
    for a, b in zip(port, ref):
        assert_runs_equal(a, b)
    pa, ja = pl.arrays(), jl.arrays()
    assert set(pa) == set(ja) and len(pl) == len(jl) > 0
    for k in ja:
        assert np.array_equal(pa[k], ja[k]), k
        assert pa[k].dtype == ja[k].dtype, k
    # a shard the port writes, the reference reads, and back
    path = pl.save(str(tmp_path / "shard.npz"))
    from repro.sim import load_translog as j_load
    for k, v in j_load(path).items():
        assert np.array_equal(v, load_translog(path)[k]), k


def test_perturbed_and_heterogeneous_lanes_are_not_ported_yet():
    """Perturbed lanes and heterogeneous machines, once refused, now replay
    as the reference's do, bit for bit: lockstep, one-lane and sequential,
    the sequential replay equal to the lockstep one."""
    jspec = pe_slowdown_spec(128, factor=3.0, t0=0, t1=2)
    pspec = P_pe_slowdown_spec(128, factor=3.0, t0=0, t1=2)
    het = sorted(HETERO_SYSTEMS)[0]
    lanes = [("tc", "epyc", "QLearn", "default", "LT"),
             ("tc", het, "QLearn", "expChunk", "LT")]
    ref = JReplay([JCell(*lanes[0], perturb=jspec), JCell(*lanes[1])],
                  T=3, backend=JAX).run()
    port = PReplay([PCell(*lanes[0], perturb=pspec), PCell(*lanes[1])],
                   T=3, backend=TORCH).run()
    for c, a, b in zip(lanes, port, ref):
        assert_runs_equal(a, b, c)
    one = PC.run_selector("tc", "epyc", "QLearn", reward="LT", T=3,
                          perturb=pspec, backend=TORCH)
    assert_runs_equal(one, ref[0])
    seq = PC.run_selector_sequential("tc", "epyc", "QLearn", reward="LT",
                                     T=3, perturb=pspec, backend=TORCH)
    assert_runs_equal(seq, ref[0])


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    # the cell's replays follow its sweep backend (the card) unless asked
    assert inspect.signature(PC.run_campaign_cell).parameters[
        "selector_backend"].default is None
    assert get_backend("python").name == "python"
    monkeypatch.setenv("REPRO_SIM_BACKEND", "jax")
    with pytest.raises(ValueError, match="unknown simulation backend"):
        get_backend(None)
    monkeypatch.delenv("REPRO_SIM_BACKEND")
    if torch.cuda.is_available():
        assert get_backend(None).device.type == "cuda"
        pytest.skip("a CUDA device is present")
    lane = PCell("tc", "epyc", "QLearn", reward="LT")
    for call in (lambda: get_backend(None),
                 lambda: PReplay([lane], T=1),
                 lambda: PC.run_selector("tc", "epyc", "QLearn", T=1),
                 lambda: PC.run_campaign([("tc", "epyc")], T=1, reps=1),
                 lambda: PC.run_campaign_cell("tc", "epyc", T=1, reps=1),
                 lambda: LoopWhatIf(get_system("epyc"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_noise_free_twin_keeps_structure():
    s = get_system("epyc")
    q = noise_free(s)
    assert (q.noise_sigma, q.jitter, q.speed_spread) == (0.0, 0.0, 0.0)
    assert dataclasses.replace(q, noise_sigma=s.noise_sigma,
                               jitter=s.jitter,
                               speed_spread=s.speed_spread) == s
