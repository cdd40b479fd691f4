"""The port's event cores (``repro_torch.kernels.event_loop``): the plain
PyTorch versions are bit-equal to the reference's Pallas kernels in
interpret mode and to its ``lax.while_loop`` core, on ties, forced rows,
``count == 0`` lanes and ragged counts.  The CUDA kernels are held against
the plain versions on the card in ``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import event_loop as J  # noqa: E402
from repro.sim import get_application  # noqa: E402
from repro.sim.backends import jax_batched as JB  # noqa: E402
from repro_torch.kernels import event_loop as T  # noqa: E402

CASES = [(8, 256, 12), (20, 1024, 10), (56, 512, 9), (128, 1024, 6)]


def _lanes(seed, P, K, B):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, K + 1, B).astype(np.int32)
    count[0], count[1] = 0, K
    forced = np.full((B, K), -1, np.int32)
    forced[2] = rng.integers(0, P, K)                  # fully forced row
    part = rng.random((B, K)) < 0.15
    part[:3] = False
    forced[part] = rng.integers(0, P, int(part.sum()))
    jitter = (rng.random((B, P)) * 45e-6).astype(np.float32)
    jitter[3] = 0.0                                    # equal jitter: ties
    speed = np.clip(1.0 + 0.01 * rng.standard_normal((B, P)), 0.8,
                    1.25).astype(np.float32)
    speed[3:5] = 1.0
    h_eff = rng.choice(np.float32([0.2e-6, 1.6e-6, 0.4e-6]), B)
    bcost = rng.choice(np.float32([0.0, 2e-6]), B)
    return rng, count, forced, jitter, speed, h_eff, bcost


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("P,K,B", CASES)
def test_event_finish_ref_equals_pallas_and_while_loop(P, K, B):
    rng, count, forced, jitter, speed, h_eff, bcost = _lanes(P, P, K, B)
    eff = (rng.random((B, K)) * 1e-4).astype(np.float32)
    eff[4] = 3e-5                                      # equal costs: ties
    args = (eff, speed, jitter, h_eff, bcost, forced, count)
    pallas = np.asarray(J.event_finish(*args, interpret=True))
    loop = np.asarray(JB._core_while(*args))
    got = T.event_finish_ref(*_t(*args)).numpy()
    np.testing.assert_array_equal(pallas, loop)
    np.testing.assert_array_equal(got, pallas)
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = T.event_finish.launches
    np.testing.assert_array_equal(T.event_finish(*_t(*args)).numpy(), got)
    assert T.event_finish.launches == before


def _fused_inputs(P, K, B):
    rng, count, forced, jitter, speed, h_eff, bcost = _lanes(P + 1, P, K, B)
    app = get_application("mandelbrot")
    grids = app.profile_stack(3).grids()
    N = app.N
    sizes = rng.integers(1, 4 * N // K, (B, K)).astype(np.int32)
    starts = (rng.random((B, K)) * (N - sizes)).astype(np.int32)
    starts[5, :8], sizes[5, :8] = 0, N                 # x = N: the grid's end
    loc = (1.0 + 0.5 * rng.random((B, K))).astype(np.float32)
    noise = np.exp(0.025 * rng.standard_normal((B, K))).astype(np.float32)
    gid = rng.integers(0, grids.shape[0], B).astype(np.int32)
    inv_n = np.full(B, 1.0 / N, np.float32)
    return (grids, gid, inv_n, starts, sizes, loc, noise, speed, jitter,
            h_eff, bcost, forced, count)


@pytest.mark.parametrize("P,K,B", CASES)
def test_event_finish_fused_ref_equals_pallas(P, K, B):
    (grids, gid, inv_n, starts, sizes, loc, noise, speed, jitter, h_eff,
     bcost, forced, count) = _fused_inputs(P, K, B)
    gscale = (np.float32(grids.shape[1] - 1) * inv_n).astype(np.float32)
    args = (grids, gid, gscale, starts, sizes, loc, noise, speed, jitter,
            h_eff, bcost, forced, count)
    pallas = np.asarray(J.event_finish_fused(*args, interpret=True))
    got = T.event_finish_fused_ref(*_t(*args)).numpy()
    np.testing.assert_array_equal(got, pallas)


def test_prefix_gather_equals_the_while_loop_path():
    """The reference's unfused campaign path (gather over the grid row, then
    ``lax.while_loop``) with its draws switched off — noise 1, no jitter,
    unit speeds — gives the same finish times as the plain fused core."""
    P, K, B = CASES[1]
    (grids, gid, inv_n, starts, sizes, loc, _, _, _, h_eff, bcost, forced,
     count) = _fused_inputs(P, K, B)
    seeds = np.arange(B, dtype=np.uint32)
    ones = np.ones(B, np.float32)
    _, _, fin = JB._batched_events_impl(
        P, "while_loop", jnp.asarray(grids), gid, inv_n, starts, sizes, loc,
        count, forced, seeds, h_eff, bcost, np.ones((B, P), np.float32), ones,
        np.float32(0.0), np.float32(0.0), np.float32(0.0))
    gscale = (np.float32(grids.shape[1] - 1) * inv_n).astype(np.float32)
    got = T.event_finish_fused_ref(*_t(
        grids, gid, gscale, starts, sizes, loc, np.ones((B, K), np.float32),
        np.ones((B, P), np.float32), np.zeros((B, P), np.float32), h_eff,
        bcost, forced, count)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fin))


def test_wrappers_refuse_other_devices():
    eff = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.event_finish(eff, *([None] * 6))
