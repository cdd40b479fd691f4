"""The port's Python event-loop engine (``repro_torch.sim.backends.python``,
host numpy) against the reference's ``repro.sim.backends.python``, bit for
bit: ``run_instance`` for every algorithm and chunk mode, clean and
perturbed, ``run_batch``, ``what_if_wave``, lockstep replays equal to
sequential ones, perturbed replays, and the committed golden Fig. 5 table
(``results/golden_fig5_t4.json``, read only).  Also ``simulate_loop`` on
the ``event_finish`` kernel's plain version against
``repro.sim.engine_jax.simulate_loop``, and how the port resolves
``REPRO_SIM_BACKEND`` and ``REPRO_EVENT_CORE``."""

import json
import os

import numpy as np
import pytest

import repro.sim.perturb as JP
from repro.sim import CellSpec as JCell
from repro.sim import ReplayBatch as JReplay
from repro.sim import campaign as JC
from repro.sim import get_application as j_app
from repro.sim import get_system as j_system
from repro.sim.backends import InstancePerturb as JIP
from repro.sim.backends import InstanceSpec as JSpec
from repro.sim.backends.python import PythonBackend as JPython

torch = pytest.importorskip("torch")

import repro_torch.sim.backends as PB  # noqa: E402
import repro_torch.sim.perturb as PP  # noqa: E402
from repro_torch import TorchBatchedBackend, convert  # noqa: E402
from repro_torch.core.portfolio import (ALGORITHM_NAMES,  # noqa: E402
                                        make_algorithm, make_portfolio)
from repro_torch.sim import CellSpec as PCell  # noqa: E402
from repro_torch.sim import ReplayBatch as PReplay  # noqa: E402
from repro_torch.sim import campaign as PC  # noqa: E402
from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim.backends import InstancePerturb as PIP  # noqa: E402
from repro_torch.sim.backends import InstanceSpec as PSpec  # noqa: E402
from repro_torch.sim.backends.python import PythonBackend  # noqa: E402
from repro_torch.sim.backends.torch_batched import (  # noqa: E402
    EVENT_CORE_ENV, resolve_event_core)
from repro_torch.sim.engine_torch import simulate_loop  # noqa: E402

from test_torch_replay import GRID, assert_runs_equal  # noqa: E402

REF = JPython()
PORT = PythonBackend()
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "results",
                      "golden_fig5_t4.json")


def _port(jprofile, jsystem):
    return (convert.profile_from_state(convert.profile_state(jprofile)),
            convert.system_from_state(convert.system_state(jsystem)))


def _assert_results_equal(a, b):
    assert (a.loop_time, a.n_chunks, a.lib, a.chunk_sizes) == (
        b.loop_time, b.n_chunks, b.lib, b.chunk_sizes)
    np.testing.assert_array_equal(a.finish, b.finish)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", range(12))
@pytest.mark.parametrize("mode", ["default", "expChunk"])
def test_run_instance_equals_the_reference(alg, mode):
    for app, system in (("mandelbrot", "broadwell"), ("tc", "cascadelake")):
        jp, js = j_app(app).loops(1)[0], j_system(system)
        pp, ps = _port(jp, js)
        cp = JC.chunk_param_for(mode, jp.N, js.P)
        a = PORT.run_instance(pp, ps, alg, cp, np.random.default_rng(alg),
                              record_chunks=True)
        b = REF.run_instance(jp, js, alg, cp, np.random.default_rng(alg),
                             record_chunks=True)
        _assert_results_equal(a, b)


@pytest.mark.parametrize("perturb", ["slowdown", "failure", "burst", "het"])
def test_run_instance_perturbed_equals_the_reference(perturb):
    system = "broadwell_het" if perturb == "het" else "broadwell"
    jp, js = j_app("hacc").loops(0)[0], j_system(system)
    pp, ps = _port(jp, js)
    pe = {"slowdown": (1.0,) * 16 + (8.0,) * 4,
          "failure": (1.0,) * 18 + (JP.FAILED_PE_FACTOR,) * 2}.get(perturb)
    ss = 6.0 if perturb == "burst" else 1.0
    jip = None if perturb == "het" else JIP(pe_scale=pe, sigma_scale=ss)
    pip = None if perturb == "het" else PIP(pe_scale=pe, sigma_scale=ss)
    for alg in range(12):
        for cp in (0, 64):
            a = PORT.run_instance(pp, ps, alg, cp, np.random.default_rng(7),
                                  True, pip)
            b = REF.run_instance(jp, js, alg, cp, np.random.default_rng(7),
                                 True, jip)
            _assert_results_equal(a, b)


def test_run_batch_and_what_if_wave_equal_the_reference():
    jprofs = j_app("sphynx").loops(0) + j_app("sphynx").loops(3)
    js = j_system("epyc")
    pprofs = [_port(p, js)[0] for p in jprofs]
    ps = _port(jprofs[0], js)[1]
    ip = (JIP(sigma_scale=2.0), PIP(sigma_scale=2.0))
    rows = [(pid, alg, cp, (3, alg, pid, cp), k)
            for pid in range(len(jprofs)) for alg in range(12)
            for cp in (0, 250) for k in (0, 1)]
    jr = REF.run_batch(jprofs, js, [JSpec(pid, a, cp, s, ip[0] if k else None)
                                    for pid, a, cp, s, k in rows])
    pr = PORT.run_batch(pprofs, ps, [PSpec(pid, a, cp, s, ip[1] if k else None)
                                     for pid, a, cp, s, k in rows])
    for f in ("loop_time", "lib", "n_chunks"):
        np.testing.assert_array_equal(getattr(pr, f), getattr(jr, f))
    rng = np.random.default_rng(5)
    prefix = np.concatenate([[0.0], np.cumsum(rng.uniform(1e-4, 3e-3, 300))])
    avail = rng.uniform(0.0, 2e-3, 8)
    for cp in (0, 4):
        got = PORT.what_if_wave(prefix, 8, avail, 2e-4, 1e-3, range(12),
                                chunk_param=cp)
        want = REF.what_if_wave(prefix, 8, avail, 2e-4, 1e-3, range(12),
                                chunk_param=cp)
        np.testing.assert_array_equal(got, want)
    # the base protocol's route fan-out over what_if_wave
    cands = [(s, a, cp) for s in range(2) for a in range(12)
             for cp in (0, 4)]
    got = PORT.what_if_routes([prefix, prefix[:120]], 8, [avail, avail[::-1]],
                              2e-4, 1e-3, cands)
    want = REF.what_if_routes([prefix, prefix[:120]], 8, [avail, avail[::-1]],
                              2e-4, 1e-3, cands)
    np.testing.assert_array_equal(got, want)


def test_host_algorithm_classes_equal_the_reference():
    from repro.core.portfolio import make_algorithm as j_make
    assert [a.name for a in make_portfolio()] == ALGORITHM_NAMES
    rng = np.random.default_rng(0)
    for idx in range(12):
        a, b = make_algorithm(idx), j_make(ALGORITHM_NAMES[idx])
        assert make_algorithm(ALGORITHM_NAMES[idx]).index == idx
        for N, P, cp in ((1000, 8, 0), (777, 5, 13)):
            a.reset(N, P, cp)
            b.reset(N, P, cp)
            while b.remaining > 0:
                pe = int(rng.integers(0, P))
                c = a.next_chunk(pe)
                assert c == b.next_chunk(pe), (idx, N, P, cp)
                t = float(rng.uniform(0.5, 2.0)) * c
                a.report(pe, c, t, t + 1e-3)
                b.report(pe, c, t, t + 1e-3)
            assert (a.remaining, a.scheduled) == (b.remaining, b.scheduled)


def test_engine_shim_reexports():
    from repro.sim import engine as j_engine
    assert set(engine.__all__) == set(j_engine.__all__)
    assert engine.run_instance is PB.python.run_instance
    assert (engine.H_ATOMIC_ADAPTIVE, engine.MUTEX_ADAPTIVE) == (
        j_engine.H_ATOMIC_ADAPTIVE, j_engine.MUTEX_ADAPTIVE)
    assert engine.EVENT_CAP == j_engine.EVENT_CAP


# ---------------------------------------------------------------------------
# replays on "python"
# ---------------------------------------------------------------------------

def test_lockstep_equals_sequential_and_the_reference():
    lanes = [c for c in GRID if c[3] == "default"]
    runs = PReplay([PCell(*c) for c in lanes], T=4, backend="python").run()
    ref = JReplay([JCell(*c) for c in lanes], T=4, backend="python").run()
    for c, run, want in zip(lanes, runs, ref):
        assert_runs_equal(run, want, c)
        seq = PC.run_selector_sequential(c[0], c[1], c[2], chunk_mode=c[3],
                                         reward=c[4], T=4, backend="python")
        assert_runs_equal(run, seq, c)


@pytest.mark.parametrize("sel", ["ReactiveSim", "AwareSim", "QLearn"])
def test_perturbed_replays_equal_the_reference(sel):
    jz = JP.pe_slowdown_spec(20, 0.2, 8.0, t0=2)
    pz = PP.pe_slowdown_spec(20, 0.2, 8.0, t0=2)
    kw = dict(reward="LT", T=5, backend="python")
    one = PC.run_selector("hacc", "broadwell", sel, perturb=pz, **kw)
    want = JC.run_selector("hacc", "broadwell", sel, perturb=jz, **kw)
    assert_runs_equal(one, want)
    seq = PC.run_selector_sequential("hacc", "broadwell", sel, perturb=pz,
                                     **kw)
    assert_runs_equal(seq, want)
    lanes = [("tc", "broadwell", sel, "expChunk", "LT"),
             ("tc", "epyc_het", sel, "default", "LT")]
    dz = JP.drift_spec("cov", t0=1, factor=1.8)
    pdz = PP.drift_spec("cov", t0=1, factor=1.8)
    ref = JReplay([JCell(*lanes[0], perturb=dz), JCell(*lanes[1])], T=3,
                  backend="python").run()
    port = PReplay([PCell(*lanes[0], perturb=pdz), PCell(*lanes[1])], T=3,
                   backend="python").run()
    for c, a, b in zip(lanes, port, ref):
        assert_runs_equal(a, b, c)


def test_golden_fig5_table():
    """The port's campaign on its Python engine reproduces the reference's
    committed golden table (read only)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    cells = [tuple(k.split("/")) for k in golden]
    results = PC.run_campaign(cells, T=4, reps=1, seed=0, backend="python",
                              selector_backend="python")
    for (app, system), cell in results.items():
        want = golden[f"{app}/{system}"]
        assert cell.oracle_total == pytest.approx(want["oracle_total"],
                                                  rel=1e-9)
        assert cell.sweep.cov() == pytest.approx(want["cov"], rel=1e-9)
        deg = {f"{s}|{m}|{r or ''}": v
               for (s, m, r), v in cell.degradation().items()}
        assert set(deg) == set(want["degradation"])
        for k, v in want["degradation"].items():
            assert deg[k] == pytest.approx(v, rel=1e-9, abs=1e-9), k
        for (s, m, r), run in cell.selector_runs.items():
            assert run.total == pytest.approx(
                want["totals"][f"{s}|{m}|{r or ''}"], rel=1e-9)


def test_run_campaign_cell_replays_on_python_by_default():
    """With ``backend="python"`` and no ``selector_backend`` the replays
    follow the sweep onto the Python engine, and the cell equals the
    reference's, whose replays take ``"python"`` by default."""
    kw = dict(T=3, reps=1, selectors=PC.SELECTOR_GRID[:4])
    cell = PC.run_campaign_cell("tc", "epyc", backend="python", **kw)
    ref = JC.run_campaign_cell("tc", "epyc", backend="python", **kw)
    assert cell.degradation() == ref.degradation()
    for key, run in cell.selector_runs.items():
        assert_runs_equal(run, ref.selector_runs[key], key)


# ---------------------------------------------------------------------------
# simulate_loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("app,system", [("mandelbrot", "broadwell"),
                                        ("tc", "epyc")])
def test_simulate_loop_equals_engine_jax(alg, app, system):
    import jax.numpy as jnp

    from repro.sim.engine_jax import simulate_loop as j_simulate

    profile = j_app(app).loops(0)[0]
    s = j_system(system)
    grid = np.asarray(profile.prefix_grid, np.float32)
    jitter = np.random.default_rng(alg).uniform(0, 1e-4, s.P).astype(
        np.float32)
    for cp, jit in ((64, None), (64, jitter), (0 if alg != 1 else 256, None)):
        mk, fin, count = j_simulate(alg, jnp.asarray(grid), profile.N, s.P,
                                    cp, h=s.h, jitter=None if jit is None
                                    else jnp.asarray(jit))
        pmk, pfin, pcount = simulate_loop(alg, grid, profile.N, s.P, cp,
                                          h=s.h, jitter=jit, device="cpu")
        assert pcount == int(count)
        np.testing.assert_array_equal(pfin.numpy(), np.asarray(fin))
        assert float(pmk) == float(mk)


def test_simulate_loop_matches_the_python_engine():
    """``tests/test_extensions.py``'s check, on the port: the noise-free
    Python engine and ``simulate_loop`` make the same decisions."""
    import dataclasses
    app = j_app("mandelbrot")
    profile, system = _port(app.loops(0)[0], j_system("broadwell"))
    quiet = dataclasses.replace(system, noise_sigma=0.0, jitter=0.0,
                                speed_spread=0.0, boundary_cost=0.0,
                                dyn_locality=0.0, loc_amp=0.0)
    for alg in (2, 4, 6):
        ref = PORT.run_instance(profile, quiet, alg, 64,
                                np.random.default_rng(0))
        mk, _, count = simulate_loop(alg, profile.prefix_grid, profile.N,
                                     quiet.P, 64, h=quiet.h, device="cpu")
        assert count == ref.n_chunks
        np.testing.assert_allclose(float(mk), ref.loop_time, rtol=2e-3)


def test_simulate_loop_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_loop(2, np.linspace(0, 1, 17, dtype=np.float32), 100, 4, 0)


# ---------------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------------

def test_sim_backend_env(monkeypatch):
    monkeypatch.delenv(PB.BACKEND_ENV, raising=False)
    assert PB.BACKEND_ENV == "REPRO_SIM_BACKEND"
    assert PB.backend_names() == ["python", "torch"]
    monkeypatch.setenv(PB.BACKEND_ENV, "Python")
    assert PB.get_backend(None) is PB.get_backend("python")
    assert isinstance(PB.get_backend(None), PythonBackend)
    for bad in ("jax", "jax-pallas", "cuda", ""):
        monkeypatch.setenv(PB.BACKEND_ENV, bad)
        with pytest.raises(ValueError, match=r"available: \['python', "
                                             r"'torch'\]"):
            PB.get_backend(None)
    with pytest.raises(ValueError, match="unknown simulation backend"):
        PB.get_backend("jax")
    bk = TorchBatchedBackend(device="cpu")
    assert PB.get_backend(bk) is bk


@pytest.mark.parametrize("env,core", [
    ("auto", "kernel"), ("kernel", "kernel"), ("pallas", "kernel"),
    ("PALLAS", "kernel"), ("plain", "plain"), ("while_loop", "plain"),
    (None, "kernel")])
def test_event_core_env(monkeypatch, env, core):
    if env is None:
        monkeypatch.delenv(EVENT_CORE_ENV, raising=False)
    else:
        monkeypatch.setenv(EVENT_CORE_ENV, env)
    assert resolve_event_core() == core
    bk = TorchBatchedBackend(device="cpu")
    assert bk.event_core == core
    assert bk.name == ("torch" if core == "kernel" else "torch-plain")
    # an explicit argument wins over the environment
    assert TorchBatchedBackend(device="cpu",
                               event_core="plain").event_core == "plain"


@pytest.mark.parametrize("env", ["triton", "mosaic", ""])
def test_event_core_env_refuses_unknown_names(monkeypatch, env):
    monkeypatch.setenv(EVENT_CORE_ENV, env)
    with pytest.raises(ValueError, match="unknown event core"):
        TorchBatchedBackend(device="cpu")
