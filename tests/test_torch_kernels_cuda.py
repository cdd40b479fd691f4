"""The CUDA kernels against their plain PyTorch versions, on the card
(marker ``cuda``; each test skips without a card).  This file imports only
torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The event-loop kernels are bit-equal to their plain versions.  The model
kernels are held within the tolerances of ``test_torch_model_kernels.py``:
float32 rmsnorm 1e-6, flash attention 1e-5, SSD 1e-4 relative to the
largest magnitude of the plain output (sums in another order); bfloat16
one bfloat16 ulp beyond that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import event_loop as T  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RMS  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.sim import get_application  # noqa: E402

# (P, K, B): every count of registers a thread (ceil(P/32) = 1 .. 4), the
# edges P = 1 and 33, B not a multiple of the 4 lanes a block, and K = 250
# (rows of no whole number of 32-chunk segments)
CASES = [(8, 256, 12), (20, 1024, 100), (56, 4096, 300), (128, 4096, 1000),
         (1, 256, 70), (16, 1024, 130), (17, 512, 67), (33, 1024, 101),
         (80, 512, 66), (8, 250, 133)]


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
@pytest.mark.parametrize("system", ["broadwell", "epyc", "epyc_het"])
def test_perturbed_backend_calls_equal_plain_versions(card, system):
    """A perturbed portfolio (four failed PEs: speeds near 1e4, the adaptive
    algorithms' weighted lanes forced whole, a noise burst) through the
    backend on the card; each recorded fused call, and the same call on
    precomputed costs, kernel against plain version."""
    from repro_torch import TorchBatchedBackend
    from repro_torch.sim import InstancePerturb, InstanceSpec, get_system
    sysm = get_system(system)
    P = sysm.P
    ip = InstancePerturb(pe_scale=tuple(
        1e4 if p in (1, P // 2, P - 2, P - 1) else 1.0 for p in range(P)),
        sigma_scale=6.0)
    profiles = get_application("mandelbrot").loops(0)
    specs = [InstanceSpec(li, alg, cp, (li, alg, cp), perturb=ip)
             for li in range(len(profiles)) for alg in range(1, 12)
             for cp in (0, 97)]
    bk = TorchBatchedBackend(device=card)
    bk.core_calls = []
    bk.run_batch(profiles, sysm, specs)
    calls = [a for n, a in bk.core_calls if n == "event_finish_fused"]
    assert calls
    whole = 0
    for args in calls:
        torch.testing.assert_close(T.event_finish_fused(*args),
                                   T.event_finish_fused_ref(*args),
                                   rtol=0, atol=0)
        eargs = [T.prefix_costs(*args[:7])] + list(args[7:])
        torch.testing.assert_close(T.event_finish(*eargs),
                                   T.event_finish_ref(*eargs), rtol=0,
                                   atol=0)
        forced, count = args[11], args[12]
        live = (torch.arange(forced.shape[1], device=card)[None, :]
                < count.long()[:, None])
        whole += int(((count > 0) & ~((forced < 0) & live).any(1)).sum())
        assert float(args[7].max()) > 1e4 * 0.8
    assert whole >= 5 * len(profiles)      # the weighted adaptive lanes


@pytest.mark.cuda
@pytest.mark.parametrize("P,K,B", [(128, 4096, 64), (20, 1024, 33)])
def test_forced_whole_lanes_with_failed_pes(card, P, K, B):
    """Every chunk of every lane forced, PE speeds up to 1.25e4."""
    args = _inputs(P, K, B, card)
    rng = np.random.default_rng(P + K)
    count = args[-1]
    args[-2] = torch.from_numpy(rng.integers(0, P, (B, K)).astype(
        np.int32)).to(card)
    mult = np.where(rng.random((B, P)) < 0.1, 1e4, 1.0).astype(np.float32)
    args[7] = args[7] * torch.from_numpy(mult).to(card)
    torch.testing.assert_close(T.event_finish_fused(*args),
                               T.event_finish_fused_ref(*args), rtol=0,
                               atol=0)
    eargs = [T.prefix_costs(*args[:7])] + args[7:]
    torch.testing.assert_close(T.event_finish(*eargs),
                               T.event_finish_ref(*eargs), rtol=0, atol=0)
    assert int(count.max()) == K


@pytest.mark.cuda
def test_fleet_with_a_group_outage_card_equals_cpu(card):
    """A 3 x 4 what-if-routed fleet of SimPolicy groups on a bursty trace,
    one whole group down for a third of it, recovery on: every wave and
    route price through ``event_finish`` on the card, and the run equals
    the CPU's bit for bit."""
    from repro_torch import TorchBatchedBackend, kernels
    from repro_torch.serving import (FleetSimulator, RecoveryPolicy,
                                     make_trace)
    from repro_torch.sim import FleetPerturb, ReplicaFailure
    trace = make_trace("bursty", 1500, seed=7, base_rate=2000.0,
                       burst_factor=6.0, p_enter=0.015, p_exit=0.05)
    d = trace.duration
    pert = FleetPerturb(failures=(ReplicaFailure(group=1, t0=d * 0.25,
                                                 t1=d * 0.6),))
    reps = []
    for device in (card, "cpu"):
        fleet = FleetSimulator(n_groups=3, replicas_per_group=4,
                               router="whatif", selector="SimPolicy",
                               backend=TorchBatchedBackend(device=device),
                               perturb=pert,
                               recovery=RecoveryPolicy(max_retries=6))
        n0 = T.event_finish.launches
        reps.append((fleet.run(trace, keep_latencies=True),
                     fleet.router.choices, T.event_finish.launches - n0))
    (card_rep, card_choices, launched), (cpu_rep, cpu_choices, none) = reps
    assert launched > 0 and none == 0
    assert kernels.launch_counts()["event_finish"] >= launched
    assert card_rep.summary() == cpu_rep.summary()
    assert np.array_equal(card_rep.latencies, cpu_rep.latencies)
    assert card_choices == cpu_choices
    assert card_rep.recovery["interrupted"] > 0


@pytest.mark.cuda
def test_async_dispatch_equals_sync_on_the_card(card):
    """Double-buffered dispatch (pinned staging, non-blocking copies, one
    event a dispatch) against the synchronous loop: a sweep of several
    dispatches and a what-if call, bit for bit, with the same launches;
    and the same calls split over the card listed twice (a fused launch a
    shard of each sweep dispatch)."""
    from repro_torch import TorchBatchedBackend, sweep_portfolio
    out = []
    for kw in ({"async_dispatch": False}, {"async_dispatch": True},
               {"devices": [card, card]}):
        bk = TorchBatchedBackend(**kw)
        n0 = T.event_finish_fused.launches
        sw = sweep_portfolio("mandelbrot", "epyc", T=20, reps=2, backend=bk)
        prefix = np.concatenate([[0.0], np.cumsum(np.linspace(1e-5, 3e-5,
                                                              300))])
        waves = bk.what_if_wave(prefix, 8, np.zeros(8), 2e-7, 5e-6,
                                list(range(12)))
        out.append((sw, waves, T.event_finish_fused.launches - n0,
                    bk.times.dispatches))
    (a, wa, na, da), (b, wb, nb, db), (c, wc, nc, dc) = out
    assert na == nb == da - 1 == db - 1 > 1   # the what-if: one dispatch
    assert nc == 2 * (dc - 1)
    for other, w in ((b, wb), (c, wc)):
        assert np.array_equal(wa, w)
        for k in a.runs:
            assert np.array_equal(a.runs[k].times, other.runs[k].times)
            assert np.array_equal(a.runs[k].libs, other.runs[k].libs)


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


# ---------------------------------------------------------------------------
# the model kernels
# ---------------------------------------------------------------------------

F32_TOL = {"rmsnorm": 1e-6, "flash": 1e-5, "ssd": 1e-4}


def _bf16_ulp(x):
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_within(got, want, kernel):
    """float32: F32_TOL relative to max |want|; bfloat16: one ulp more."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    bound = F32_TOL[kernel] * max(float(w.abs().max()), 1e-30)
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        err = err - torch.maximum(_bf16_ulp(g), _bf16_ulp(w))
    assert float(err.max()) <= bound, (float(err.max()), bound)


def _randn(shape, dtype, device, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


#: every path and edge of the forward's layout (kernels/rmsnorm.py::layout):
#: a block a row (decode's 8 x 3584 and 8 x 7168, 256 decode slots of
#: 3584, and 131, 132 and 524 rows of 3072, too few for the row path's
#: groups to fill the SMs), the row path (the training call 2 x 2048 x
#: 3072; 525 rows, the fewest of 3072 it takes; 1001 rows, no whole number
#: of groups a block), sub-warp groups (QK-norm's D = 128 over 16,384 rows,
#: and at qwen3-32b's prefill calls: 8 x 2048 tokens of 64 query heads,
#: 1,048,576 rows, and of 8 kv heads, 131,072 rows; and D = 100 over
#: 20,000, no multiple of the 16-byte chunk, element by
#: element), D = 100 and odd D = 4097 (misaligned rows, element by element,
#: a ragged last chunk) over a block a row, the widest bf16 row the row
#: path holds (12,288: three chunks of 512 threads) and the wide path
#: beyond it (16,384 and 20,000)
RMS_SHAPES = [(8, 128), (3, 17, 64), (16, 3584), (8, 3584), (8, 7168),
              (5, 7168), (256, 3584), (131, 3072), (132, 3072),
              (524, 3072), (525, 3072), (2, 2048, 3072), (1001, 3072),
              (8, 2048, 128), (8, 2048, 64, 128), (8, 2048, 8, 128),
              (3, 17, 100), (1000, 100), (20000, 100),
              (300, 4097), (300, 12288), (300, 16384), (3, 20000),
              (200, 20000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16")])
def test_rmsnorm_kernel_matches_plain_version(card, shape, xd, wd):
    x = _randn(shape, DT[xd], card, sum(shape))
    w = _randn(shape[-1:], DT[wd], card, 1)
    n0 = RMS.rmsnorm.launches
    got = RMS.rmsnorm(x, w)
    assert RMS.rmsnorm.launches == n0 + 1
    assert_within(got, RMS.rmsnorm_ref(x, w), "rmsnorm")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2048, 3072), (8, 7168), (8, 2048, 128),
                                   (300, 4097), (3, 20000)])
def test_rmsnorm_kernel_reruns_bit_equal(card, shape):
    """No atomics and a fixed order of sums: a rerun gives the same bits
    (bf16 x and w; each path of the layout)."""
    x = _randn(shape, torch.bfloat16, card, 3)
    w = _randn(shape[-1:], torch.bfloat16, card, 4)
    assert torch.equal(RMS.rmsnorm(x, w), RMS.rmsnorm(x, w))


@pytest.mark.cuda
def test_rmsnorm_of_no_rows_launches_nothing(card):
    x = _randn((0, 3072), torch.bfloat16, card, 0)
    n0 = RMS.rmsnorm.launches
    out = RMS.rmsnorm(x, _randn((3072,), torch.bfloat16, card, 1))
    assert out.shape == (0, 3072) and RMS.rmsnorm.launches == n0


#: the last three but one are the edges the bfloat16 kernel's tiles must
#: mask at the serving head dim: ragged S and T with GQA, S < T against a
#: long key range with one kv head, and a full 2048-token prefill; then
#: llama3.2-3b's training call cut to 6 / 2 heads (groups of 3, hd 128),
#: and the serving prefills of qwen3-32b (groups of 8: 64 / 8 heads, cut
#: to 16 / 2) and olmoe-1b-7b (groups of 1: 16 / 16 heads, cut to 4 / 4);
#: last, whisper-small's calls cut to 2 of its 12 heads of 64: the
#: encoder's 1,500 frames (no multiple of the 64-key tile), the decoder's
#: 32-token prompt against them, and decode's one query against them
FLASH = [(1, 128, 128, 4, 4, 64), (2, 96, 160, 8, 2, 32),
         (1, 257, 129, 6, 3, 64), (2, 256, 256, 4, 4, 112),
         (2, 100, 72, 4, 2, 112), (1, 300, 300, 2, 1, 128),
         (1, 257, 129, 6, 3, 112), (2, 64, 2048, 4, 1, 112),
         (1, 2048, 2048, 2, 2, 112), (1, 2048, 2048, 6, 2, 128),
         (1, 2048, 2048, 16, 2, 128), (2, 2048, 2048, 4, 4, 128),
         (2, 1500, 1500, 2, 2, 64), (2, 32, 1500, 2, 2, 64),
         (3, 1, 1500, 2, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(card, B, S, T, H, K, hd,
                                            causal, dtype):
    q = _randn((B, S, H, hd), DT[dtype], card, 1)
    k = _randn((B, T, K, hd), DT[dtype], card, 2)
    v = _randn((B, T, K, hd), DT[dtype], card, 3)
    n0 = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.flash_attention.launches == n0 + 1
    assert_within(got, FA.flash_attention_ref(q, k, v, causal=causal),
                  "flash")


#: the forward's row lse (float32 in both dtypes) against the plain lse,
#: relative to the largest magnitude (sums in another order)
LSE_REL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_lse_matches_plain_lse(card, B, S, T, H, K, hd, causal,
                                            dtype):
    """The lse the forward kernel stores when asked matches the plain lse,
    and asking for it leaves the output's bits as they are."""
    q = _randn((B, S, H, hd), DT[dtype], card, 1)
    k = _randn((B, T, K, hd), DT[dtype], card, 2)
    v = _randn((B, T, K, hd), DT[dtype], card, 3)
    n0 = FA.flash_attention.launches
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    assert FA.flash_attention.launches == n0 + 1
    want = FA.flash_attention_lse_ref(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    err = float((lse - want).abs().max())
    assert err <= LSE_REL * float(want.abs().max()), err
    assert torch.equal(o, FA.flash_attention(q, k, v, causal=causal))


#: small shapes, then the edges of the bfloat16 kernels' head blocks and
#: chunk-parallel passes: 3 heads in a block of 4 with 16 chunks of 16, 6 heads (a block
#: and a half) over 8 chunks of 256, and the serving width of 112 heads in
#: one chunk of 1024; the last four run the tiles of 128 state columns:
#: st = 96 (zero-filled to 128), Mamba2-2.7B's 128 at its 80 heads and
#: chunk of 256, an odd st of 101 (rows of B and C no float4 chunks), and
#: 128 in one chunk of 1024
SSD_CASES = [(1, 64, 4, 32, 16, 16), (2, 128, 8, 32, 16, 32),
             (1, 96, 6, 16, 8, 32), (2, 512, 8, 64, 64, 256),
             (1, 256, 3, 64, 64, 128), (1, 256, 3, 64, 64, 16),
             (2, 2048, 6, 64, 64, 256), (1, 1024, 112, 64, 64, 1024),
             (2, 512, 6, 64, 96, 256), (1, 1024, 80, 64, 128, 256),
             (1, 192, 3, 32, 101, 64), (1, 1024, 4, 64, 128, 1024)]


def _ssd_args(b, S, nh, hp, st, dtype, device):
    rng = np.random.default_rng(b * S + nh)
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
        (b, S, nh)))) * 0.1).astype(np.float32)).to(device)
    A = torch.from_numpy((-np.exp(rng.standard_normal(nh) * 0.3)
                          ).astype(np.float32)).to(device)
    return (_randn((b, S, nh, hp), DT[dtype], device, 4, 0.5), dt, A,
            _randn((b, S, st), torch.float32, device, 5, 0.5),
            _randn((b, S, st), torch.float32, device, 6, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,nh,hp,st,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_version(card, b, S, nh, hp, st, chunk,
                                          dtype):
    args = _ssd_args(b, S, nh, hp, st, dtype, card)
    n0 = SSD.ssd_scan.launches
    y, h = SSD.ssd_scan(*args, chunk=chunk)
    assert SSD.ssd_scan.launches == n0 + 1
    y_ref, h_ref = SSD.ssd_scan_ref(*args, chunk=chunk)
    assert_within(y, y_ref, "ssd")
    assert_within(h, h_ref, "ssd")


@pytest.mark.cuda
def test_model_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = _randn((1, 8, 2, 136), torch.float32, card, 0)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    q = _randn((1, 8, 2, 64), torch.float32, card, 0)
    with pytest.raises(TypeError, match="dtype"):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="is on"):
        RMS.rmsnorm(q, torch.ones(64))
    args = _ssd_args(1, 64, 2, 96, 16, "float32", card)
    with pytest.raises(ValueError, match="exceed"):
        SSD.ssd_scan(*args, chunk=32)
    args = _ssd_args(1, 64, 2, 32, 136, "float32", card)
    with pytest.raises(ValueError, match="exceed"):
        SSD.ssd_scan(*args, chunk=32)


# ---------------------------------------------------------------------------
# the backward kernels (training)
# ---------------------------------------------------------------------------

#: bfloat16 gradients against the plain versions' autograd (float32 math,
#: rounded once): relative L2 <= 2**-8.  The flash backward takes delta =
#: rowsum(dO * o) from the bfloat16 output where autograd uses its float32
#: value (~1.4e-3 in relative L2, emulated on the CPU); float32 is held
#: within 1e-5 (flash) and 1e-6 (rmsnorm) of the largest magnitude
BWD_REL_L2_BF16 = 2.0 ** -8


def _check_grads(got, want, dtype, kernel):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g.float()).all())
        if dtype == "float32":
            assert_within(g, w, kernel)
        else:
            rel = float((g.float() - w.float()).norm() / w.float().norm())
            assert rel <= BWD_REL_L2_BF16, rel


#: the last four: D odd (element-wise loads), the training shape (8,192
#: rows of 3,072), rows wider than the kernel's registers hold, and
#: olmoe's QK-norm in training (65,536 rows of 128)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (3, 17, 64), (300, 3072),
                                   (5, 7168), (37, 1001), (4, 2048, 3072),
                                   (3, 20000), (4, 1024, 16, 128)])
@pytest.mark.parametrize("xd,wd", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16")])
def test_rmsnorm_bwd_kernel_matches_plain_autograd(card, shape, xd, wd):
    x = _randn(shape, DT[xd], card, sum(shape))
    w = _randn(shape[-1:], DT[wd], card, 1)
    dy = _randn(shape, DT[xd], card, 2)
    n0 = RMS.rmsnorm_bwd.launches
    got = RMS.rmsnorm_bwd(x, w, dy)
    assert RMS.rmsnorm_bwd.launches == n0 + 1
    want = RMS.rmsnorm_bwd_ref(x, w, dy)
    _check_grads(got[:1], want[:1], xd, "rmsnorm")
    _check_grads(got[1:], want[1:], wd, "rmsnorm")
    again = RMS.rmsnorm_bwd(x, w, dy)          # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))


#: GQA and MHA, causal or not, ragged tiles, hd 32 / 64 / 112 / 128, the
#: dense training shape cut to one batch row, olmoe's training call (16
#: query and 16 kv heads, no grouping), and whisper-small's training calls
#: cut to 2 of its 12 heads of 64: the encoder's 1,500 frames (the last
#: 64-key tile holds 28 keys) and the decoder's 448 queries over them
FLASH_BWD = [(1, 128, 128, 4, 4, 64), (2, 96, 160, 8, 2, 32),
             (1, 257, 129, 6, 3, 64), (2, 100, 72, 4, 2, 112),
             (1, 300, 300, 6, 2, 128), (1, 2048, 2048, 24, 8, 128),
             (4, 1024, 1024, 16, 16, 128), (2, 1500, 1500, 2, 2, 64),
             (2, 448, 1500, 2, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH_BWD)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain_autograd(card, B, S, T, H, K, hd,
                                                 causal, dtype):
    q = _randn((B, S, H, hd), DT[dtype], card, 1)
    k = _randn((B, T, K, hd), DT[dtype], card, 2)
    v = _randn((B, T, K, hd), DT[dtype], card, 3)
    do = _randn((B, S, H, hd), DT[dtype], card, 4)
    o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    n0 = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert FA.flash_attention_bwd.launches == n0 + 1
    want = FA.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    _check_grads(got, want, dtype, "flash")
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd(q, k, v, o, do, None, causal=causal)


@pytest.mark.cuda
def test_autograd_goes_through_the_backward_kernels(card):
    """With autograd recording, the wrappers launch the forward kernels
    inside Functions whose backwards are the backward kernels; under
    no_grad (serving) they launch the forward kernels alone, as before."""
    x = _randn((2, 64, 4, 64), torch.bfloat16, card, 5).requires_grad_()
    w = _randn((64,), torch.bfloat16, card, 6).requires_grad_()
    n = (RMS.rmsnorm.launches, RMS.rmsnorm_bwd.launches,
         FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    h = RMS.rmsnorm(x, w)
    out = FA.flash_attention(h, h[:, :, :2].contiguous(),
                             h[:, :, 2:].contiguous())
    assert out.grad_fn is not None and h.grad_fn is not None
    out.float().square().sum().backward()
    assert (RMS.rmsnorm.launches, RMS.rmsnorm_bwd.launches,
            FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == tuple(c + 1 for c in n)
    assert bool(x.grad.abs().sum() > 0) and bool(w.grad.abs().sum() > 0)
    with torch.no_grad():
        h = RMS.rmsnorm(x, w)
        out = FA.flash_attention(h, h, h)
    assert out.grad_fn is None
    assert (RMS.rmsnorm_bwd.launches, FA.flash_attention_bwd.launches) == (
        n[1] + 1, n[3] + 1)
    args = [t.requires_grad_() for t in _ssd_args(1, 64, 2, 32, 16,
                                                  "float32", card)]
    n = (SSD.ssd_scan.launches, SSD.ssd_scan_bwd.launches)
    y, _ = SSD.ssd_scan(*args, chunk=32)
    assert y.grad_fn is not None
    y.square().sum().backward()
    assert (SSD.ssd_scan.launches, SSD.ssd_scan_bwd.launches) == (
        n[0] + 1, n[1] + 1)
    assert all(bool(t.grad.abs().sum() > 0) for t in args)
    with torch.no_grad():
        y, _ = SSD.ssd_scan(*args, chunk=32)
    assert y.grad_fn is None
    assert (SSD.ssd_scan.launches, SSD.ssd_scan_bwd.launches) == (
        n[0] + 2, n[1] + 1)


#: (b, S, nh, hp, st, chunk): states 16 / 64 / 96 / 128 (kS = 64 and 128),
#: one chunk and several, a chunk of 96 rows (a ragged 64-row tile), a
#: head group cut short (nh = 3, 5, 7) and the longest chunk
SSD_BWD_CASES = [(1, 64, 2, 32, 16, 32), (2, 256, 4, 64, 64, 64),
                 (1, 512, 3, 64, 96, 128), (2, 512, 8, 64, 128, 256),
                 (1, 256, 4, 64, 128, 256), (1, 192, 5, 48, 40, 96),
                 (1, 1024, 4, 64, 128, 1024), (1, 512, 7, 64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,nh,hp,st,chunk", SSD_BWD_CASES)
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_kernel_matches_plain_autograd(card, b, S, nh, hp, st,
                                               chunk, with_dstate, dtype):
    args = _ssd_args(b, S, nh, hp, st, dtype, card)
    dy = _randn((b, S, nh, hp), DT[dtype], card, 7, 0.5)
    dstate = (_randn((b, nh, hp, st), torch.float32, card, 8, 0.5)
              if with_dstate else None)
    n0 = SSD.ssd_scan_bwd.launches
    got = SSD.ssd_scan_bwd(*args, dy, dstate, chunk=chunk)
    assert SSD.ssd_scan_bwd.launches == n0 + 1
    if dtype == "float32":
        # float32 against the exact gradient (the plain version in
        # float64): the float32 kernel sums cum in float64, and the
        # float32 plain version's rounding of cum can pass the tolerance
        want = [w.float() for w in SSD.ssd_scan_bwd_ref(
            *(t.double() for t in args), dy.double(),
            None if dstate is None else dstate.double(), chunk=chunk)]
    else:
        want = SSD.ssd_scan_bwd_ref(*args, dy, dstate, chunk=chunk)
    _check_grads(got, want, dtype, "ssd")
    again = SSD.ssd_scan_bwd(*args, dy, dstate, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _up64(n):
    return -(-n // 64) * 64


def _bf16_workspace(b, S, nh, hp, st, chunk, nt, npair, ngr):
    """The bf16 backward's scratch in float32 values for row groups ``ngr``:
    B and C as planes of kS = 64 or 128 state columns, each chunk's state
    and its gradient's part, the totals, cum and dt by head, H and G as
    planes of 64 rows, C B^T by tile pair, dC partials by row group, dB
    partials by row group and tile pair, dcum by row tile, its part through
    G, dT's parts by column tile, <G, H>, dA's partials and the ticket,
    each part rounded up to 64 values."""
    nc, ks = S // chunk, (64 if st <= 64 else 128)
    bs, bcn = b * S, b * nc * nh
    return (2 * _up64(bs * ks) + 2 * _up64(bcn * hp * st) + _up64(bcn)
            + 2 * _up64(bs * nh) + 2 * _up64(bcn * 64 * ks)
            + _up64(b * nc * npair * 64 * 64) + ngr * _up64(bs * st)
            + _up64(ngr * b * nc * npair * 64 * st) + _up64(bcn * nt * chunk)
            + _up64(bs * nh) + _up64(bcn * nt) + 2 * _up64(bcn) + 64)


@pytest.mark.cuda
def test_bwd_workspace_matches_its_parts(card):
    """The backward's scratch, as ``csrc/ssd_scan_bwd.cu``'s ``Workspace``
    lays it out for each dtype of x and its ``ssd_scan_bwd_workspace_floats``
    reports it, each part rounded up to 64 values.  float32: two states per
    (batch, chunk, head), the chunks' totals and dA partials, dB and dC
    partials by group of 4 heads (``kHG``), and the tickets.  bfloat16
    (mamba2-2.7b's 4 x 2048 call: 4 row tiles a chunk, 10 tile pairs, 3
    row groups): as ``_bf16_workspace`` sums it."""
    b, S, nh, hp, st, chunk = 4, 2048, 80, 64, 128, 256
    nc, groups = S // chunk, -(-nh // 4)
    assert SSD._bwd_workspace_floats(b, S, nh, hp, st, chunk,
                                     torch.float32) == (
        2 * _up64(b * nc * nh * hp * st) + 2 * _up64(b * nc * nh)
        + 2 * _up64(b * S * groups * st) + _up64(b * nc + 1))
    assert SSD._bwd_workspace_floats(b, S, nh, hp, st, chunk,
                                     torch.bfloat16) == _bf16_workspace(
        b, S, nh, hp, st, chunk, 4, 10, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,nh,chunk,want", [
    (4, 2048, 80, 256, (4, 10, 3)),    # mamba2-2.7b: 27 heads a group
    (4, 2048, 112, 256, (4, 10, 4)),   # Zamba2: 28 heads a group
    (4, 1024, 80, 256, (4, 10, 3)),    # mamba2's 4 x 1024 training call
    (1, 256, 8, 64, (1, 1, 4)),        # 4 tiles: 4 groups of 2 heads
    (1, 1024, 7, 1024, (16, 136, 4)),  # one chunk of 16 tiles, 7 heads
    (2, 64, 1, 32, (1, 1, 1))])        # a single head
def test_bwd_layout_fills_the_card_within_the_head_limit(card, b, S, nh,
                                                         chunk, want):
    """The bf16 backward's row groups (``Layout`` in the kernel's source,
    read through the workspace's size, which has a dB partial a group):
    at most 32 heads each (``kMaxRowHeads``), as few as that allows, and
    more (of 2 heads at least) where the rows kernel would launch fewer
    than 132 blocks (``kFill``)."""
    nt, npair, ngr = want
    assert SSD._bwd_workspace_floats(b, S, nh, 64, 128, chunk,
                                     torch.bfloat16) == _bf16_workspace(
        b, S, nh, 64, 128, chunk, nt, npair, ngr)


#: (b, S, nh, hp, st, chunk): the bf16 tensor-core kernels' edges: state
#: columns kS = 64 and 128 each with the longest chunk (1024, sixteen
#: 64-row tiles), hp < 64, and head counts that are no whole number of
#: their head pairs, column groups of 4 and row groups (5, 7, 9 and 33
#: heads; 33 takes two row groups at the 32-head limit)
SSD_BWD_BF16_CASES = [(1, 1024, 5, 64, 64, 1024), (1, 2048, 7, 48, 128, 1024),
                      (1, 512, 9, 32, 96, 256), (2, 256, 33, 64, 128, 128),
                      (1, 384, 3, 16, 40, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,S,nh,hp,st,chunk", SSD_BWD_BF16_CASES)
@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_bwd_bf16_kernels_at_their_edges(card, b, S, nh, hp, st, chunk,
                                             with_dstate):
    args = _ssd_args(b, S, nh, hp, st, "bfloat16", card)
    dy = _randn((b, S, nh, hp), torch.bfloat16, card, 9, 0.5)
    dstate = (_randn((b, nh, hp, st), torch.float32, card, 10, 0.5)
              if with_dstate else None)
    got = SSD.ssd_scan_bwd(*args, dy, dstate, chunk=chunk)
    want = SSD.ssd_scan_bwd_ref(*args, dy, dstate, chunk=chunk)
    _check_grads(got, want, "bfloat16", "ssd")
    again = SSD.ssd_scan_bwd(*args, dy, dstate, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_warm_kernels_of_the_ssm_family_builds_no_flash_kernel(card):
    """``warm_kernels`` of mamba2 (no attention) launches rmsnorm and the
    SSD scan forward and backward, and no flash-attention kernel; of
    Zamba2 (hybrid) all of them."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.autotune import warm_kernels
    for arch, flash in (("mamba2-2.7b", 0), ("zamba2-7b", 1)):
        kernels.reset_launch_counts()
        warm_kernels(get_config(arch), card)
        n = kernels.launch_counts()
        assert n["rmsnorm"] >= 1 and n["rmsnorm_bwd"] >= 1, n
        assert n["ssd_scan"] == 1 and n["ssd_scan_bwd"] == 1, n
        assert n["flash_attention"] == n["flash_attention_bwd"] == flash, n


@pytest.mark.cuda
def test_warm_kernels_of_the_moe_family_builds_no_ssd_kernel(card):
    """``warm_kernels`` of olmoe launches rmsnorm and flash attention,
    forward and backward, and no SSD kernel."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.autotune import warm_kernels
    kernels.reset_launch_counts()
    warm_kernels(get_config("olmoe-1b-7b"), card)
    n = kernels.launch_counts()
    assert n["rmsnorm"] >= 1 and n["rmsnorm_bwd"] >= 1, n
    assert n["flash_attention"] == n["flash_attention_bwd"] == 1, n
    assert n["ssd_scan"] == n["ssd_scan_bwd"] == 0, n


@pytest.mark.cuda
def test_warm_kernels_of_the_encdec_family_builds_no_ssd_kernel(card):
    """``warm_kernels`` of whisper-small launches flash attention, forward
    and backward, and no SSD kernel and no rmsnorm (its norms are
    LayerNorms)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.autotune import warm_kernels
    kernels.reset_launch_counts()
    warm_kernels(get_config("whisper-small"), card)
    n = kernels.launch_counts()
    assert n["flash_attention"] == n["flash_attention_bwd"] == 1, n
    assert n["ssd_scan"] == n["ssd_scan_bwd"] == 0, n
    assert n["rmsnorm"] == n["rmsnorm_bwd"] == 0, n


def _moe_layer_grads(args, k, remat):
    """``moe_block``'s output, ``dropped_frac`` and gradients for its five
    inputs under a fixed output gradient, the block checkpointed under
    ``remat``."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models.layers import moe_block
    leaves = [a.detach().requires_grad_() for a in args]
    if remat:
        out, aux = checkpoint(lambda *a: moe_block(*a, k=k), *leaves,
                              use_reentrant=False)
    else:
        out, aux = moe_block(*leaves, k=k)
    dy = _randn(out.shape, out.dtype, out.device, 9, 0.1)
    return (out.detach(), float(aux["dropped_frac"]),
            torch.autograd.grad(out, leaves, dy))


@pytest.mark.cuda
def test_moe_block_backward_at_full_width_reruns_bit_equal(card):
    """One olmoe MoE layer at training size in bf16 (4,096 tokens, D 2,048,
    64 experts, top-8, F 1,024; the tokens share a component, so the
    router favours some experts and tokens are dropped): its output and
    the gradients of x, the router and the expert weights are bit-equal
    across two runs, and bit-equal under a checkpoint (the backward
    recomputes the routing and the capacity mask)."""
    T, D, E, F, k = 4096, 2048, 64, 1024, 8
    bf16 = torch.bfloat16
    x = _randn((T, D), torch.float32, card, 1) + \
        _randn((1, D), torch.float32, card, 6, 0.5)
    args = [x.to(bf16),
            _randn((D, E), bf16, card, 2, D ** -0.5),
            _randn((E, D, F), bf16, card, 3, D ** -0.5),
            _randn((E, D, F), bf16, card, 4, D ** -0.5),
            _randn((E, F, D), bf16, card, 5, F ** -0.5)]
    runs = [_moe_layer_grads(args, k, remat) for remat in
            (False, False, True)]
    out0, dropped, grads0 = runs[0]
    assert dropped > 0.05
    for out, d, grads in runs[1:]:
        assert torch.equal(out, out0) and d == dropped
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert all(bool(torch.isfinite(g.float()).all()) and
               float(g.float().abs().max()) > 0 for g in grads0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_gets_a_gradient_on_the_card(card, dtype):
    """One backward of the smoke llama on the card: no leaf (no layer of a
    stacked leaf) is without a gradient, and the loss and gradients are
    finite; float32 agrees with the CPU within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import tree_items, tree_map
    cfg = dataclasses.replace(smoke_reduce(get_config("llama3.2-3b")),
                              param_dtype=dtype)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32))
    runs = []
    for dev in (card, "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        b = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        runs.append(value_and_grad(lambda p, b: loss_fn(cfg, p, b), p, b))
    (loss, _), grads = runs[0]
    assert bool(torch.isfinite(loss))
    for path, g in tree_items(grads):
        assert bool(torch.isfinite(g.float()).all()), path
        per = g.float().reshape(g.shape[0], -1).abs().sum(1) \
            if path[0] == "layers" else g.float().abs().sum().reshape(1)
        assert bool((per > 0).all()), path
    if dtype == "float32":
        (cpu_loss, _), cpu_grads = runs[1]
        assert abs(float(loss) - float(cpu_loss)) <= 1e-4 * float(cpu_loss)
        for (path, g), (_, c) in zip(tree_items(grads), tree_items(cpu_grads)):
            err = float((g.cpu() - c).abs().max() / c.abs().max())
            assert err <= 1e-4, (path, err)
