"""The portfolio sweep of the port (``repro_torch.sim.campaign``) against the
reference's, at the paper's full width (P = 128, the application's own N),
T = 2, one rep: the same Oracle, the same c.o.v. and the same loop times,
noise-free and noisy, on the CPU."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sim import campaign as JC  # noqa: E402
from repro.sim import get_application, get_system  # noqa: E402
from repro.sim.backends.jax_batched import JaxBatchedBackend  # noqa: E402
from repro_torch import TorchBatchedBackend, convert  # noqa: E402
from repro_torch.sim import campaign as TC  # noqa: E402
from repro_torch.sim import get_application as t_app  # noqa: E402

JAX = JaxBatchedBackend(kernel="while_loop")
TORCH = TorchBatchedBackend(device="cpu")
PAIRS = [(alg, mode) for alg in range(12) for mode in JC.CHUNK_MODES]


def _quiet_sweeps(app_name):
    system = dataclasses.replace(get_system("epyc"), noise_sigma=0.0,
                                 jitter=0.0, speed_spread=0.0)
    tsys = convert.system_from_state(convert.system_state(system))
    j = JC._run_portfolio(get_application(app_name), system, PAIRS, 2, 1, 0,
                          backend=JAX)
    t = TC._run_portfolio(t_app(app_name), tsys, PAIRS, 2, 1, 0,
                          backend=TORCH)
    return (JC.PortfolioSweep(app_name, "epyc", j),
            TC.PortfolioSweep(app_name, "epyc", t))


def _assert_sweeps_equal(js, ts, T, n_loops):
    assert sorted(ts.runs, key=str) == sorted(js.runs, key=str)
    for key, run in ts.runs.items():
        assert run.times.shape == (T, n_loops)
        np.testing.assert_array_equal(run.times, js.runs[key].times)
        np.testing.assert_array_equal(run.libs, js.runs[key].libs)
    np.testing.assert_array_equal(ts.oracle_argmin(), js.oracle_argmin())
    assert ts.oracle_total() == js.oracle_total()
    assert ts.cov() == js.cov()


@pytest.mark.parametrize("app_name,n_loops", [("tc", 1), ("mandelbrot", 3)])
def test_noise_free_sweep_bit_equal(app_name, n_loops):
    js, ts = _quiet_sweeps(app_name)
    _assert_sweeps_equal(js, ts, 2, n_loops)


@pytest.mark.parametrize("app_name,n_loops", [("tc", 1), ("mandelbrot", 3)])
def test_noisy_sweep_bit_equal(app_name, n_loops):
    js = JC.sweep_portfolio(app_name, "epyc", T=2, reps=1, backend=JAX)
    ts = TC.sweep_portfolio(app_name, "epyc", T=2, reps=1, backend=TORCH)
    _assert_sweeps_equal(js, ts, 2, n_loops)


def test_time_invariant_apps_tile_their_window():
    """tc is time-invariant: 24 simulated steps tile to T (the reference's
    window), so T = 30 repeats the first six steps."""
    ts = TC.sweep_portfolio("tc", "epyc", T=30, reps=1, backend=TORCH)
    run = ts.runs[(2, "default")]
    assert run.times.shape == (30, 1)
    np.testing.assert_array_equal(run.times[24:], run.times[:6])


def test_run_fixed_and_chunk_modes():
    app = t_app("tc")
    system = convert.system_from_state(convert.system_state(
        get_system("broadwell")))
    fr = TC.run_fixed(app, system, 6, "expChunk", T=2, reps=1,
                      backend=TORCH)
    assert fr.times.shape == (2, 1) and fr.total > 0
    assert TC.chunk_param_for("default", 1 << 20, 20) == 0
    assert TC.chunk_param_for("expChunk", 1 << 20, 20) == \
        JC.chunk_param_for("expChunk", 1 << 20, 20)
    with pytest.raises(ValueError):
        TC.chunk_param_for("guided", 10, 2)
