"""``TorchBatchedBackend`` on the CPU against the reference's
``JaxBatchedBackend(kernel="while_loop")``, with the reference's own state
handed to both engines (``repro_torch.convert``).

Loop times and chunk counts are bit-equal, with noise and without: the
port's threefry draws, XLA-form ``log1p``/``exp``/``erf_inv`` and fused
multiply-adds reproduce the reference's float32 arithmetic.  ``lib`` is a
float32 row mean, which XLA and torch sum in different orders, so it agrees
within ``LIB_ATOL`` percentage points.  What-if prices agree at rtol 5e-7,
the reference's own bar for its float64 host gather."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import get_application, get_system  # noqa: E402
from repro.sim.backends import InstanceSpec as JSpec  # noqa: E402
from repro.sim.backends import InstancePerturb  # noqa: E402
from repro.sim.backends import LockstepRequest as JReq  # noqa: E402
from repro.sim.backends.jax_batched import JaxBatchedBackend  # noqa: E402
from repro.sim.campaign import chunk_param_for  # noqa: E402
from repro_torch import TorchBatchedBackend, convert  # noqa: E402
from repro_torch.sim.backends import InstanceSpec as TSpec  # noqa: E402
from repro_torch.sim.backends import LockstepRequest as TReq  # noqa: E402

JAX = JaxBatchedBackend(kernel="while_loop")
TORCH = TorchBatchedBackend(device="cpu")
#: float32 row mean summed in another order: a few ulp of the mean, scaled
#: by 100 / makespan (measured up to 4e-5 over every app and system)
LIB_ATOL = 1e-4


def _both(system, app, steps):
    jprofs = [p for t in steps for p in app.loops(t)]
    tprofs = [convert.profile_from_state(convert.profile_state(p))
              for p in jprofs]
    tsys = convert.system_from_state(convert.system_state(system))
    return jprofs, tprofs, tsys


def _specs(n_profiles, algs, N, P, reps=2):
    return [(pid, alg, chunk_param_for(mode, N, P),
             (11, alg, mode == "default", pid, r))
            for alg in algs for mode in ("default", "expChunk")
            for pid in range(n_profiles) for r in range(reps)]


def _assert_batches_equal(jr, tr):
    np.testing.assert_array_equal(tr.loop_time, jr.loop_time)
    np.testing.assert_array_equal(tr.n_chunks, jr.n_chunks)
    np.testing.assert_allclose(tr.lib, jr.lib, rtol=0, atol=LIB_ATOL)


def _quiet(system):
    return dataclasses.replace(system, noise_sigma=0.0, jitter=0.0,
                               speed_spread=0.0)


@pytest.mark.parametrize("alg", range(12))
def test_noise_free_run_batch_bit_equal(alg):
    system = _quiet(get_system("epyc"))
    app = get_application("mandelbrot")
    jp, tp, ts = _both(system, app, (0, 250, 499))
    specs = _specs(len(jp), [alg], app.N, system.P)
    jr = JAX.run_batch(jp, system, [JSpec(*s) for s in specs])
    tr = TORCH.run_batch(tp, ts, [TSpec(*s) for s in specs])
    _assert_batches_equal(jr, tr)


@pytest.mark.parametrize("app_name,system_name", [
    ("mandelbrot", "epyc"), ("mandelbrot", "broadwell"), ("tc", "epyc"),
    ("tc", "cascadelake"), ("lulesh", "epyc"), ("sphynx", "cascadelake"),
    ("hacc", "epyc"), ("stream", "broadwell")])
def test_noisy_run_batch_bit_equal(app_name, system_name):
    system = get_system(system_name)
    app = get_application(app_name)
    jp, tp, ts = _both(system, app, (3,))
    specs = _specs(len(jp), range(12), app.N, system.P, reps=1)
    jr = JAX.run_batch(jp, system, [JSpec(*s) for s in specs])
    tr = TORCH.run_batch(tp, ts, [TSpec(*s) for s in specs])
    _assert_batches_equal(jr, tr)


def test_lockstep_equals_sequential_and_the_reference():
    system = get_system("cascadelake")
    app = get_application("sphynx")
    jp, tp, ts = _both(system, app, (0, 7))
    lanes = [(pid, alg, cp) for pid in range(len(jp)) for alg in range(12)
             for cp in (0, 977)]

    def rngs():
        return [np.random.default_rng((5, i)) for i in range(len(lanes))]

    lock = TORCH.run_lockstep(tp, ts, [TReq(p, a, c, g) for (p, a, c), g
                                       in zip(lanes, rngs())])
    seq = [TORCH.run_instance(tp[p], ts, a, c, g)
           for (p, a, c), g in zip(lanes, rngs())]
    np.testing.assert_array_equal(lock.loop_time,
                                  [r.loop_time for r in seq])
    np.testing.assert_array_equal(lock.n_chunks, [r.n_chunks for r in seq])
    ref = JAX.run_lockstep(jp, system, [JReq(p, a, c, g) for (p, a, c), g
                                        in zip(lanes, rngs())])
    np.testing.assert_array_equal(lock.loop_time, ref.loop_time)
    np.testing.assert_array_equal(lock.n_chunks, ref.n_chunks)


def test_run_instance_records_the_reference_chunks():
    system = get_system("broadwell")
    app = get_application("hacc")
    jp, tp, ts = _both(system, app, (0,))
    for alg, cp in ((2, 0), (5, 300), (7, 0), (0, 0), (1, 0)):
        want = JAX.run_instance(jp[0], system, alg, cp,
                                np.random.default_rng(alg),
                                record_chunks=True)
        got = TORCH.run_instance(tp[0], ts, alg, cp,
                                 np.random.default_rng(alg),
                                 record_chunks=True)
        assert got.loop_time == want.loop_time
        assert got.n_chunks == want.n_chunks
        assert got.chunk_sizes == want.chunk_sizes
        np.testing.assert_array_equal(got.finish, want.finish)


def _wave(seed, n, R):
    rng = np.random.default_rng(seed)
    prefix = np.concatenate([[0.0], np.cumsum(2e-5 + 1e-6 * rng.lognormal(
        5.0, 1.0, n))])
    return prefix, rng.random(R) * 1e-3


@pytest.mark.parametrize("cp", [0, 3, 16])
def test_what_if_wave_agrees(cp):
    prefix, avail = _wave(cp, 256, 8)
    algs = list(range(12))
    want = JAX.what_if_wave(prefix, 8, avail, 0.2e-6, 5e-6, algs,
                            chunk_param=cp)
    got = TORCH.what_if_wave(prefix, 8, avail, 0.2e-6, 5e-6, algs,
                             chunk_param=cp)
    np.testing.assert_allclose(got, want, rtol=5e-7)


def test_what_if_wave_float64_prefix_precision():
    rng = np.random.default_rng(0)
    prefix = np.concatenate([[0.0], np.cumsum(rng.random(16384) * 1e-2)])
    avail = rng.random(16) * 1e-3
    algs = [1, 2, 3, 6]
    want = JAX.what_if_wave(prefix, 16, avail, 2e-4, 1e-3, algs,
                            chunk_param=4)
    got = TORCH.what_if_wave(prefix, 16, avail, 2e-4, 1e-3, algs,
                             chunk_param=4)
    np.testing.assert_allclose(got, want, rtol=5e-7)


def test_what_if_routes_agrees():
    R = 8
    prefixes, avails = [], []
    for s, n in enumerate((37, 256, 120, 0, 301, 64)):
        p, a = _wave(10 + s, n, R)
        prefixes.append(p)
        avails.append(a)
    cands = [(s, a, cp) for s in range(6) for a in range(12)
             for cp in (0, 4)]
    want = JAX.what_if_routes(prefixes, R, avails, 0.2e-6, 5e-6, cands)
    got = TORCH.what_if_routes(prefixes, R, avails, 0.2e-6, 5e-6, cands)
    assert got.shape == (len(cands),)
    np.testing.assert_allclose(got, want, rtol=5e-7)


def test_perturbed_and_heterogeneous_lanes_are_refused():
    system = get_system("epyc")
    app = get_application("tc")
    _, tp, ts = _both(system, app, (0,))
    slow = InstancePerturb(pe_scale=(2.0,) + (1.0,) * 127)
    with pytest.raises(NotImplementedError):
        TORCH.run_batch(tp, ts, [TSpec(0, 2, 0, (1,), perturb=slow)])
    het = convert.system_from_state(
        convert.system_state(get_system("epyc_het")))
    with pytest.raises(NotImplementedError):
        TORCH.run_instance(tp[0], het, 2, 0, np.random.default_rng(0))
    # a neutral perturbation is exactly no perturbation
    neutral = InstancePerturb(pe_scale=(1.0,) * 128)
    a = TORCH.run_batch(tp, ts, [TSpec(0, 2, 0, (1,), perturb=neutral)])
    b = TORCH.run_batch(tp, ts, [TSpec(0, 2, 0, (1,))])
    np.testing.assert_array_equal(a.loop_time, b.loop_time)


def test_schedule_caches_are_bounded_and_grids_uploaded_once():
    bk = TorchBatchedBackend(device="cpu")
    for N in range(1000, 1000 + 600):
        bk._central_schedule(2, N, 8, 0)
    assert len(bk._sched_cache) == 512
    system = get_system("epyc")
    app = get_application("mandelbrot")
    _, tp, ts = _both(system, app, (0,))
    g1 = bk._grids_dev(tp)
    _, tp2, _ = _both(system, app, (0,))    # equal profiles, new objects
    assert bk._grids_dev(tp2) is g1
    assert g1.shape == (8, 16385) and g1.dtype == torch.float32
