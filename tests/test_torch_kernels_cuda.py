"""The CUDA event-loop kernels against their plain PyTorch versions, on the
card (marker ``cuda``; each test skips without a card).  This file imports
only torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import event_loop as T  # noqa: E402
from repro_torch.sim import get_application  # noqa: E402

CASES = [(8, 256, 12), (20, 1024, 100), (56, 4096, 300), (128, 4096, 1000)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(P, K, B, device):
    """Lanes with ragged counts (0 and K included), fully and partly forced
    rows, equal jitter and equal costs (exact ties), and chunks that end at
    the grid's last point."""
    rng = np.random.default_rng(P * K + B)
    app = get_application("mandelbrot")
    grids = app.profile_stack(3).grids()
    N = app.N
    count = rng.integers(0, K + 1, B).astype(np.int32)
    count[0], count[1] = 0, K
    forced = np.full((B, K), -1, np.int32)
    forced[2] = rng.integers(0, P, K)
    part = rng.random((B, K)) < 0.15
    part[:3] = False
    forced[part] = rng.integers(0, P, int(part.sum()))
    jitter = (rng.random((B, P)) * 45e-6).astype(np.float32)
    jitter[3] = 0.0
    speed = np.clip(1.0 + 0.01 * rng.standard_normal((B, P)), 0.8,
                    1.25).astype(np.float32)
    h_eff = rng.choice(np.float32([0.2e-6, 1.6e-6]), B)
    bcost = rng.choice(np.float32([0.0, 2e-6]), B)
    sizes = rng.integers(1, max(2, 4 * N // K), (B, K)).astype(np.int32)
    starts = (rng.random((B, K)) * (N - sizes)).astype(np.int32)
    starts[4, :8], sizes[4, :8] = 0, N
    loc = (1.0 + 0.5 * rng.random((B, K))).astype(np.float32)
    noise = np.exp(0.025 * rng.standard_normal((B, K))).astype(np.float32)
    loc[5], noise[5] = 1.0, 1.0
    gid = rng.integers(0, grids.shape[0], B).astype(np.int32)
    gscale = np.full(B, np.float32(grids.shape[1] - 1) * np.float32(1.0 / N),
                     np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        grids, gid, gscale, starts, sizes, loc, noise, speed, jitter, h_eff,
        bcost, forced, count)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,K,B", CASES)
def test_fused_kernel_equals_plain_version(card, P, K, B):
    args = _inputs(P, K, B, card)
    n0 = T.event_finish_fused.launches
    got = T.event_finish_fused(*args)
    assert T.event_finish_fused.launches == n0 + 1
    torch.testing.assert_close(got, T.event_finish_fused_ref(*args),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("P,K,B", CASES)
def test_kernel_equals_plain_version(card, P, K, B):
    fargs = _inputs(P, K, B, card)
    args = [T.prefix_costs(*fargs[:7])] + fargs[7:]
    n0 = T.event_finish.launches
    got = T.event_finish(*args)
    assert T.event_finish.launches == n0 + 1
    torch.testing.assert_close(got, T.event_finish_ref(*args), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    args = _inputs(8, 256, 12, card)
    eff = [T.prefix_costs(*args[:7])] + args[7:]
    with pytest.raises(ValueError, match="exceeds"):
        wide = torch.zeros((12, 129), device=card)
        T.event_finish(eff[0], wide, wide, *eff[3:])
    with pytest.raises(TypeError, match="dtype"):
        T.event_finish(eff[0].double(), *eff[1:])
    with pytest.raises(ValueError, match="contiguous"):
        T.event_finish(eff[0].t().contiguous().t(), *eff[1:])
    with pytest.raises(ValueError, match="is on"):
        T.event_finish(eff[0], eff[1].cpu(), *eff[2:])
