"""Perturbed and heterogeneous machines in the port against the reference, on
the CPU: ``repro_torch.sim.perturb`` resolves and transforms as
``repro.sim.perturb``; ``weighted_adaptive_schedule`` emits the reference's
schedules; and ``TorchBatchedBackend(device="cpu")`` gives the results of
``JaxBatchedBackend(kernel="while_loop")`` bit for bit on perturbed and
heterogeneous lanes — ``run_batch``, ``run_lockstep``, ``run_instance``, the
lockstep and sequential replays and the two-pass what-if prices.  The noise
burst holds the per-lane noise scale's association
(``(sigma * sigma_scale) * sqrt(2)`` before ``erf_inv(u)``), and clean
lanes stay bit-equal next to perturbed ones."""

import dataclasses

import numpy as np
import pytest

import repro.sim.perturb as JP
from repro.core.jaxsched import weighted_adaptive_schedule as j_weighted
from repro.sim import CellSpec as JCell
from repro.sim import LoopWhatIf as JWhatIf
from repro.sim import ReplayBatch as JReplay
from repro.sim import campaign as JC
from repro.sim import get_application as j_app
from repro.sim import get_system as j_system
from repro.sim.backends import InstancePerturb as JIP
from repro.sim.backends import InstanceSpec as JSpec
from repro.sim.backends import LockstepRequest as JReq
from repro.sim.backends.jax_batched import JaxBatchedBackend

torch = pytest.importorskip("torch")

import repro_torch.sim.perturb as PP  # noqa: E402
from repro_torch import TorchBatchedBackend, convert  # noqa: E402
from repro_torch.core.sched import (ADAPTIVE_SCHEDULABLE,  # noqa: E402
                                    weighted_adaptive_schedule)
from repro_torch.sim import CellSpec as PCell  # noqa: E402
from repro_torch.sim import LoopWhatIf  # noqa: E402
from repro_torch.sim import ReplayBatch as PReplay  # noqa: E402
from repro_torch.sim import campaign as PC  # noqa: E402
from repro_torch.sim import get_application, get_system  # noqa: E402
from repro_torch.sim.backends import InstancePerturb as PIP  # noqa: E402
from repro_torch.sim.backends import InstanceSpec as PSpec  # noqa: E402
from repro_torch.sim.backends import LockstepRequest as PReq  # noqa: E402
from repro_torch.sim.backends import combined_pe_scale  # noqa: E402
from repro_torch.sim.backends.torch_batched import (  # noqa: E402
    ADAPTIVE_REWEIGHT_ENV, resolve_adaptive_reweight)
from repro_torch.sim.workloads import profile_digest  # noqa: E402

from repro.sim import TransitionLogger as JLog  # noqa: E402
from repro_torch.sim import TransitionLogger as PLog  # noqa: E402
from test_torch_replay import assert_runs_equal  # noqa: E402
from test_torch_replay import learned_default  # noqa: E402,F401

JAX = JaxBatchedBackend(kernel="while_loop")
TORCH = TorchBatchedBackend(device="cpu")


def _failed(P, pes):
    return tuple(PP.FAILED_PE_FACTOR if p in pes else 1.0 for p in range(P))


#: (name, pe_scale builder of P or None, sigma_scale) — one of each kind
PERTURBS = [
    ("slowdown", lambda P: (1.0,) * (P - 4) + (8.0,) * 4, 1.0),
    ("failure", lambda P: _failed(P, (1, P - 1)), 1.0),
    ("burst", None, 6.0),
    ("slow_burst", lambda P: (1.0,) * (P - 3) + (3.0,) * 3, 2.5),
]


def _ips(kind, P):
    _, scale, ss = next(p for p in PERTURBS if p[0] == kind)
    pe = None if scale is None else scale(P)
    return JIP(pe_scale=pe, sigma_scale=ss), PIP(pe_scale=pe, sigma_scale=ss)


def _both(system_name, app_name, steps):
    system = j_system(system_name)
    jprofs = [p for t in steps for p in j_app(app_name).loops(t)]
    tprofs = [convert.profile_from_state(convert.profile_state(p))
              for p in jprofs]
    tsys = convert.system_from_state(convert.system_state(system))
    return jprofs, system, tprofs, tsys


def _assert_batches_equal(jr, tr):
    np.testing.assert_array_equal(tr.loop_time, jr.loop_time)
    np.testing.assert_array_equal(tr.n_chunks, jr.n_chunks)
    np.testing.assert_array_equal(tr.lib, jr.lib)


# ---------------------------------------------------------------------------
# resolution and drift transforms
# ---------------------------------------------------------------------------

SPECS = {
    "windows": lambda M: M.PerturbationSpec(
        slowdowns=(M.PESlowdown(pes=(0, 21), factor=4.0, t0=2, t1=5),),
        failures=(M.PEFailure(pes=(3,), t0=3),),
        noise_bursts=(M.NoiseBurst(factor=3.0, t0=4),)),
    "pe_slowdown": lambda M: M.pe_slowdown_spec(128, 0.2, 8.0, t0=1),
    "noise_burst": lambda M: M.noise_burst_spec(6.0, t0=0, t1=3),
    "drift": lambda M: M.drift_spec("N", t0=1, factor=2.0),
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("P", [20, 128])
def test_instance_perturb_resolves_as_the_reference(name, P):
    j, p = SPECS[name](JP), SPECS[name](PP)
    assert p.has_drift == j.has_drift
    for t in range(7):
        a, b = p.instance_perturb(t, P), j.instance_perturb(t, P)
        assert (a is None) == (b is None), t
        if a is not None:
            assert a.key() == b.key() and a.neutral == b.neutral, t


def test_spec_errors_and_constants():
    assert PP.FAILED_PE_FACTOR == JP.FAILED_PE_FACTOR
    with pytest.raises(ValueError, match="unknown drift kind"):
        PP.WorkloadDrift(kind="entropy")
    spec = PP.PerturbationSpec(slowdowns=[PP.PESlowdown(pes=[1.0], factor=2)])
    assert spec.slowdowns[0].pes == (1,) and hash(spec) == hash(
        PP.PerturbationSpec(slowdowns=(PP.PESlowdown((1,), 2),)))
    assert PP.PerturbationSpec().instance_perturb(0, 8) is None
    assert set(PP.__all__) == set(JP.__all__)


@pytest.mark.parametrize("kind,kw", [
    ("N", dict(factor=2.0)), ("N", dict(factor=0.37)),
    ("cov", dict(factor=1.8)), ("cov", dict(factor=0.5)),
    ("phase", dict(phase_shift=7))])
@pytest.mark.parametrize("app", ["tc", "sphynx", "stream"])
def test_drift_loops_equal_the_reference(kind, kw, app):
    j = JP.drift_spec(kind, t0=1, **kw)
    p = PP.drift_spec(kind, t0=1, **kw)
    for t in (0, 1, 3):
        a = p.loops(get_application(app), t)
        b = j.loops(j_app(app), t)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert (x.N, x.total) == (y.N, y.total)
            if y.prefix_grid is None:
                assert x.prefix_grid is None
            else:
                np.testing.assert_array_equal(x.prefix_grid, y.prefix_grid)
                assert x.prefix_grid.dtype == y.prefix_grid.dtype


# ---------------------------------------------------------------------------
# weighted adaptive schedules
# ---------------------------------------------------------------------------

def _weights(kind, P):
    rng = np.random.default_rng(P)
    w = {"slow_tail": np.r_[np.ones(P - 2), [0.25, 0.25]],
         "random": rng.uniform(0.1, 3.0, P),
         "failed": np.r_[np.full(P - 1, 1.0), [1e-4]],
         "uniform": np.ones(P)}[kind]
    return w * (P / w.sum())


@pytest.mark.parametrize("alg", sorted(ADAPTIVE_SCHEDULABLE))
@pytest.mark.parametrize("wkind", ["slow_tail", "random", "failed",
                                   "uniform"])
@pytest.mark.parametrize("N,P,cp", [(10_000, 8, 0), (262_144, 128, 39),
                                    (1000, 20, 7)])
def test_weighted_adaptive_schedule_equals_the_reference(alg, wkind, N, P,
                                                         cp):
    w = _weights(wkind, P)
    sizes, pes = weighted_adaptive_schedule(alg, N, P, cp, w)
    js, jp = j_weighted(alg, N, P, cp, w)
    np.testing.assert_array_equal(sizes, js)
    np.testing.assert_array_equal(pes, jp)
    assert sizes.dtype == js.dtype and pes.dtype == jp.dtype
    assert sizes.sum() == N


def test_weighted_adaptive_schedule_refuses_what_the_reference_refuses():
    assert ADAPTIVE_SCHEDULABLE == frozenset({7, 8, 9, 10, 11})
    with pytest.raises(ValueError, match="not an adaptive"):
        weighted_adaptive_schedule(2, 100, 8, 0, np.ones(8))
    with pytest.raises(ValueError, match="positive"):
        weighted_adaptive_schedule(7, 100, 8, 0, np.zeros(8))


# ---------------------------------------------------------------------------
# the batched backend on perturbed / heterogeneous lanes
# ---------------------------------------------------------------------------

def _all_specs(jprofs, P, ip=None, seed=3):
    return [(pid, alg, JC.chunk_param_for(mode, jprofs[pid].N, P),
             (seed, alg, pid, mode == "default"), ip)
            for alg in range(12) for mode in ("default", "expChunk")
            for pid in range(len(jprofs))]


def _run_both(jprofs, jsys, tprofs, tsys, rows, jax=JAX, port=TORCH):
    jr = jax.run_batch(jprofs, jsys, [JSpec(pid, a, cp, s, perturb=ip[0]
                                            if ip else None)
                                      for pid, a, cp, s, ip in rows])
    tr = port.run_batch(tprofs, tsys, [PSpec(pid, a, cp, s, perturb=ip[1]
                                             if ip else None)
                                       for pid, a, cp, s, ip in rows])
    return jr, tr


@pytest.mark.parametrize("kind", [p[0] for p in PERTURBS])
@pytest.mark.parametrize("system", ["broadwell", "broadwell_het"])
def test_perturbed_run_batch_bit_equal(kind, system):
    jprofs, jsys, tprofs, tsys = _both(system, "mandelbrot", (0,))
    ips = _ips(kind, jsys.P)
    rows = _all_specs(jprofs, jsys.P, ips)
    _assert_batches_equal(*_run_both(jprofs, jsys, tprofs, tsys, rows))


def test_heterogeneous_machine_clean_lanes_bit_equal():
    jprofs, jsys, tprofs, tsys = _both("broadwell_het", "hacc", (0, 1))
    rows = _all_specs(jprofs, jsys.P)
    _assert_batches_equal(*_run_both(jprofs, jsys, tprofs, tsys, rows))


@pytest.mark.parametrize("system", ["epyc", "epyc_het"])
def test_full_width_machine_slowdown_bit_equal(system):
    jprofs, jsys, tprofs, tsys = _both(system, "mandelbrot", (0,))
    pe = PP.pe_slowdown_spec(128, 0.2, 8.0).instance_perturb(0, 128).pe_scale
    ips = (JIP(pe_scale=pe), PIP(pe_scale=pe))
    rows = [r for r in _all_specs(jprofs[:1], 128, ips)
            if r[1] in (2, 4, 7, 8, 11)]
    _assert_batches_equal(*_run_both(jprofs, jsys, tprofs, tsys, rows))


def test_adaptive_reweight_off_bit_equal(monkeypatch):
    monkeypatch.setenv(ADAPTIVE_REWEIGHT_ENV, "0")
    jax, port = (JaxBatchedBackend(kernel="while_loop"),
                 TorchBatchedBackend(device="cpu"))
    assert not jax.adaptive_reweight and not port.adaptive_reweight
    jprofs, jsys, tprofs, tsys = _both("broadwell", "hacc", (0,))
    ips = _ips("slowdown", jsys.P)
    rows = [r for r in _all_specs(jprofs, jsys.P, ips) if r[1] >= 7]
    off = _run_both(jprofs, jsys, tprofs, tsys, rows, jax, port)
    _assert_batches_equal(*off)
    on = TORCH.run_batch(tprofs, tsys, [PSpec(pid, a, cp, s, perturb=ip[1])
                                        for pid, a, cp, s, ip in rows])
    assert not np.array_equal(on.loop_time, off[1].loop_time)


def test_adaptive_reweight_resolution(monkeypatch):
    monkeypatch.delenv(ADAPTIVE_REWEIGHT_ENV, raising=False)
    assert resolve_adaptive_reweight() is True
    assert TorchBatchedBackend(device="cpu").adaptive_reweight
    monkeypatch.setenv(ADAPTIVE_REWEIGHT_ENV, "0")
    assert resolve_adaptive_reweight() is False
    assert resolve_adaptive_reweight(True) is True
    assert TorchBatchedBackend(device="cpu",
                               adaptive_reweight=True).adaptive_reweight
    monkeypatch.setenv(ADAPTIVE_REWEIGHT_ENV, "1")
    assert resolve_adaptive_reweight(False) is False


def test_weighted_lanes_are_forced_whole():
    """Under a non-uniform PE scale every chunk of an adaptive lane is
    forced to its PE; the other lanes keep the argmin (or StaticSteal's
    own forced PEs)."""
    _, _, tprofs, tsys = _both("broadwell", "hacc", (0,))
    ip = _ips("slowdown", tsys.P)[1]
    for alg in range(1, 12):
        cp = 1000 if alg in (1, 5) else 0   # SS and StaticSteal step events
        rows = TORCH._event_rows(PSpec(0, alg, cp, (1,), perturb=ip),
                                 tprofs[0], tsys,
                                 combined_pe_scale(tsys, ip))
        if alg in ADAPTIVE_SCHEDULABLE or alg == 5:
            assert rows[3] is not None and (rows[3] >= 0).all(), alg
        else:
            assert rows[3] is None, alg


def test_run_lockstep_and_run_instance_bit_equal():
    jprofs, jsys, tprofs, tsys = _both("broadwell_het", "mandelbrot", (0,))
    jb, pb = _ips("slow_burst", jsys.P)
    reqs = [(pid, alg, cp, ip) for pid in range(len(jprofs))
            for alg in (0, 1, 2, 5, 7, 9, 11) for cp in (0, 97)
            for ip in ((jb, pb), None)]
    jr = JAX.run_lockstep(jprofs, jsys, [
        JReq(pid, a, cp, np.random.default_rng([pid, a, cp]),
             perturb=ip[0] if ip else None) for pid, a, cp, ip in reqs])
    tr = TORCH.run_lockstep(tprofs, tsys, [
        PReq(pid, a, cp, np.random.default_rng([pid, a, cp]),
             perturb=ip[1] if ip else None) for pid, a, cp, ip in reqs])
    _assert_batches_equal(jr, tr)
    for alg in (0, 2, 8, 11):
        a = TORCH.run_instance(tprofs[0], tsys, alg, 0,
                               np.random.default_rng(alg), True, pb)
        b = JAX.run_instance(jprofs[0], jsys, alg, 0,
                             np.random.default_rng(alg), True, jb)
        assert (a.loop_time, a.n_chunks, a.chunk_sizes) == (
            b.loop_time, b.n_chunks, b.chunk_sizes), alg
        np.testing.assert_array_equal(a.finish, b.finish)
        # the port's run_instance reports the batch's float32 lib
        c = JAX.run_batch(jprofs[:1], jsys, [JSpec(0, alg, 0, (5,),
                                                    perturb=jb)])
        d = TORCH.run_batch(tprofs[:1], tsys, [PSpec(0, alg, 0, (5,),
                                                     perturb=pb)])
        _assert_batches_equal(c, d)


def test_noise_burst_takes_the_reference_association():
    """sigma_scale = 6 and 2.5 on every event algorithm: the per-lane noise
    factor is ``(sigma * ss) * sqrt(2)``, rounded twice, as compiled."""
    jprofs, jsys, tprofs, tsys = _both("cascadelake", "tc", (0,))
    for ss in (6.0, 2.5, 1.0 / 3.0):
        ips = (JIP(sigma_scale=ss), PIP(sigma_scale=ss))
        rows = [r for r in _all_specs(jprofs, jsys.P, ips, seed=int(ss * 7))
                if r[1] != 0]
        _assert_batches_equal(*_run_both(jprofs, jsys, tprofs, tsys, rows))


def test_clean_lanes_unchanged_next_to_perturbed_and_caches_clean():
    _, _, tprofs, tsys = _both("broadwell", "hacc", (0,))
    bk = TorchBatchedBackend(device="cpu")
    ip = _ips("slowdown", tsys.P)[1]
    clean = [PSpec(0, a, 0, (31, a)) for a in (2, 7, 11)]
    pert = [dataclasses.replace(s, perturb=ip) for s in clean]
    r0 = bk.run_batch(tprofs, tsys, clean)
    mixed = bk.run_batch(tprofs, tsys, [x for pair in zip(clean, pert)
                                        for x in pair])
    r1 = bk.run_batch(tprofs, tsys, clean)
    for r in (r1, ):
        np.testing.assert_array_equal(r.loop_time, r0.loop_time)
        np.testing.assert_array_equal(r.lib, r0.lib)
    np.testing.assert_array_equal(mixed.loop_time[0::2], r0.loop_time)
    np.testing.assert_array_equal(mixed.lib[0::2], r0.lib)
    assert not np.array_equal(mixed.loop_time[1::2], r0.loop_time)
    # weighted schedules live only in the row cache, under keys that end
    # in their weight tuple; the schedule cache holds clean entries only
    weighted = [k for k in bk._rows_cache._d
                if isinstance(k[-1], tuple) and len(k[-1]) == tsys.P]
    assert weighted and len(weighted) < len(bk._rows_cache._d)
    assert bk._sched_cache._d and all(len(k) == 4
                                      for k in bk._sched_cache._d)


# ---------------------------------------------------------------------------
# replays and pricing with perturb=
# ---------------------------------------------------------------------------

REPLAY_SPECS = {
    "slowdown": lambda M: M.pe_slowdown_spec(20, 0.2, 6.0, t0=1),
    "failure": lambda M: M.PerturbationSpec(
        failures=(M.PEFailure(pes=(3, 17), t0=2),)),
    "burst": lambda M: M.noise_burst_spec(6.0, t0=1),
    "drift_cov": lambda M: M.drift_spec("cov", t0=1, factor=1.8),
    "drift_phase": lambda M: M.drift_spec("phase", t0=2, phase_shift=5),
}


@pytest.mark.parametrize("name", sorted(REPLAY_SPECS))
def test_replay_batch_perturbed_bit_equal(name):
    jz, pz = REPLAY_SPECS[name](JP), REPLAY_SPECS[name](PP)
    lanes = [("mandelbrot", "broadwell", "ExpertSel", "default", None),
             ("mandelbrot", "broadwell", "QLearn", "expChunk", "LT"),
             ("mandelbrot", "broadwell", "ReactiveSim", "default", "LT"),
             ("mandelbrot", "broadwell", "AwareSim", "default", "LT")]
    pert = (True, True, True, True) if name != "drift_cov" else (
        True, False, True, True)
    ref = JReplay([JCell(*c, perturb=jz if p else None)
                   for c, p in zip(lanes, pert)], T=4, backend=JAX).run()
    port = PReplay([PCell(*c, perturb=pz if p else None)
                    for c, p in zip(lanes, pert)], T=4, backend=TORCH).run()
    for c, a, b in zip(lanes, port, ref):
        assert_runs_equal(a, b, c)


def test_run_selector_and_sequential_perturbed_bit_equal():
    jz, pz = REPLAY_SPECS["slowdown"](JP), REPLAY_SPECS["slowdown"](PP)
    kw = dict(reward="LT", T=4)
    ref = JC.run_selector("hacc", "broadwell", "AwareSim", perturb=jz,
                          backend=JAX, **kw)
    one = PC.run_selector("hacc", "broadwell", "AwareSim", perturb=pz,
                          backend=TORCH, **kw)
    assert_runs_equal(one, ref)
    seq = PC.run_selector_sequential("hacc", "broadwell", "AwareSim",
                                     perturb=pz, backend=TORCH, **kw)
    assert_runs_equal(seq, ref)
    assert seq.total != PC.run_selector("hacc", "broadwell", "AwareSim",
                                        backend=TORCH, **kw).total


def test_drifted_lane_keeps_its_clean_sibling():
    dz = PP.drift_spec("N", t0=0, factor=2.0)
    clean = PCell(app="tc", system="broadwell", selector="ExpertSel")
    drifted = dataclasses.replace(clean, perturb=dz)
    solo = PReplay([clean], T=3, backend=TORCH).run()[0]
    both = PReplay([clean, drifted], T=3, backend=TORCH).run()
    assert both[0].total == solo.total and both[0].history == solo.history
    assert both[1].total > 1.5 * solo.total


def test_two_pass_whatif_prices_bit_equal():
    system = get_system("broadwell")
    profile = get_application("hacc").loops(0)[0]
    jprofile = j_app("hacc").loops(0)[0]
    assert profile_digest(profile) == profile_digest(jprofile)
    jip, pip = _ips("slowdown", system.P)
    pw = LoopWhatIf(system, backend=TORCH, two_pass=True)
    jw = JWhatIf(j_system("broadwell"), backend=JAX, two_pass=True)
    pw.set_context(profile, 0, perturb=pip)
    jw.set_context(jprofile, 0, perturb=jip)
    cands, jc = pw.candidates(), jw.candidates()
    got, want = pw.price(cands), jw.price(jc)
    assert [vars(o) for o in got] == [vars(o) for o in want]
    assert [vars(o) for o in pw.last_clean] == [vars(o)
                                                for o in jw.last_clean]
    assert [o.loop_time for o in got] != [o.loop_time
                                          for o in pw.last_clean]
    # blind pricing ignores the perturbation; a neutral one is dropped
    blind = LoopWhatIf(system, backend=TORCH)
    blind.set_context(profile, 0)
    clean = [o.loop_time for o in blind.price(cands)]
    blind.set_context(profile, 0, perturb=pip)
    assert [o.loop_time for o in blind.price(cands)] == clean
    pw.set_context(profile, 0, perturb=PIP())
    assert pw._perturb is None
    assert [o.loop_time for o in pw.price(cands)] == clean


def test_learned_lanes_and_translog_see_the_perturbation(learned_default):
    """Learned lanes' featurizer and the translog rows receive the step's
    ``InstancePerturb``: decisions, states and logged telemetry equal the
    reference's on a perturbed and on a heterogeneous lane."""
    jz, pz = REPLAY_SPECS["failure"](JP), REPLAY_SPECS["failure"](PP)
    lanes = [("tc", "broadwell", "Learned", "default", "LT"),
             ("tc", "broadwell_het", "LearnedHybrid", "expChunk", "LIB"),
             ("mandelbrot", "broadwell", "SimPolicy", "default", "LT")]
    pert = (True, False, True)
    jl, pl = JLog(sim_backend=JAX), PLog(sim_backend=TORCH)
    ref = JReplay([JCell(*c, perturb=jz if p else None)
                   for c, p in zip(lanes, pert)], T=4, backend=JAX,
                  translog=jl).run()
    port = PReplay([PCell(*c, perturb=pz if p else None)
                    for c, p in zip(lanes, pert)], T=4, backend=TORCH,
                   translog=pl).run()
    for c, a, b in zip(lanes, port, ref):
        assert_runs_equal(a, b, c)
    pa, ja = pl.arrays(), jl.arrays()
    assert set(pa) == set(ja) and len(pl) == len(jl) > 0
    for k in ja:
        assert np.array_equal(pa[k], ja[k]), k
