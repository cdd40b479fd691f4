"""The event-loop kernels' argmin arithmetic, spelled out on the CPU
(``repro_torch.kernels.event_loop``: ``order_keys``, ``warp_argmin``).

The kernels map each float to an order-preserving 32-bit key and take two
integer minima over a (32 threads, ceil(P/32) registers) layout.  They must
pick the lowest index of the least value, as ``torch.argmin`` and
``jnp.argmin`` do, on exact ties (inside one thread's registers and across
threads), -0.0 beside +0.0, +inf, denormals and values across exponents.

XLA's CPU runtime treats denormals as zero, so ``jnp.argmin`` on the CPU
sees a row with its denormals flushed to signed zeros; the kernels do not
flush (they are built without ``-ftz``), as torch does not.  Each row is
therefore held against ``torch.argmin`` as it is and against ``jnp.argmin``
through the same flush applied to the helper's input."""

import os
import sys

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _hypothesis_fallback import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import event_loop as T  # noqa: E402

PS = [1, 8, 16, 17, 20, 32, 33, 56, 127, 128]
TINY = np.finfo(np.float32).tiny          # least normal float32
DENORMS = np.float32([1.4e-45, 2.8e-45, 1e-40, 5.9e-39, 1.1e-38])


def _flush(rows: np.ndarray) -> np.ndarray:
    """Denormals to zeros of their sign, as XLA's CPU runtime reads them."""
    return np.where(np.abs(rows) < TINY, np.copysign(np.float32(0), rows),
                    rows)


def _check_rows(rows: np.ndarray) -> None:
    """The kernels' argmin picks what ``torch.argmin`` picks, and
    (denormals flushed) what ``jnp.argmin`` picks."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    x = torch.from_numpy(rows)
    want = torch.argmin(x, dim=1)
    flat = torch.from_numpy(_flush(rows))
    want_jax = torch.from_numpy(np.array(jnp.argmin(rows, axis=1))).long()
    torch.testing.assert_close(torch.argmin(flat, dim=1), want_jax)
    got = T.warp_argmin(x)
    assert torch.equal(got, want), (got, want)
    assert torch.equal(T.warp_argmin(flat), want_jax)


def _rows(kind: str, P: int, rng) -> np.ndarray:
    """Rows of one edge case at width P."""
    base = (1.0 + rng.random((6, P))).astype(np.float32)
    lo = np.float32(0.5)
    if kind == "ties_in_thread":
        # equal minima at PEs t, t + 32, t + 64, ... (one thread's slots),
        # and at the last PE alone with the first
        for i, t in enumerate((0, 5, 31)):
            base[i, t::32] = lo
        base[3, [0, P - 1]] = lo
        base[4, P - 1::-32] = lo                 # from the last PE down
        base[5] = lo                             # the whole row equal
    elif kind == "ties_across_threads":
        for i in range(6):
            picks = rng.choice(P, size=min(P, 1 + i), replace=False)
            base[i, picks] = lo
        base[0, [P // 2, P - 1]] = lo
    elif kind == "signed_zero":
        base[0, :] = 0.0
        base[0, ::2] = -0.0                       # -0.0 first: a tie
        base[1, :] = -0.0
        base[1, P // 2:] = 0.0
        base[2, P - 1] = -0.0
        base[2, 0] = 0.0 if P > 1 else -0.0
        base[3, (3 * P) // 4] = -0.0
        base[4] = -base[4]
        base[4, P // 3] = -0.0                    # not the minimum
        base[5, ::3] = 0.0
    elif kind == "inf":
        base[0] = np.inf                         # all +inf: index 0
        base[1, : P - 1] = np.inf                # only the last is finite
        base[2, ::2] = np.inf
        base[3, -1] = -np.inf
        base[4, 0] = np.inf
        base[5] = np.float32(3.4e38)
        base[5, P // 2] = np.inf
    elif kind == "denormals":
        base[0] = rng.choice(DENORMS, P)          # all denormal
        base[1] = rng.choice(DENORMS, P)
        base[1, P - 1] = 0.0                     # zero below them
        base[2, : P // 2] = DENORMS[0]           # ties among denormals
        base[3] = -rng.choice(DENORMS, P)
        base[4, P // 2] = DENORMS[2]             # one denormal, the least
        base[5, ::2] = -0.0
        base[5, 1::2] = DENORMS[0]
    elif kind == "exponents":
        e = rng.integers(-126, 127, (6, P)).astype(np.float32)
        s = np.where(rng.random((6, P)) < 0.5, -1.0, 1.0)
        base = (s * np.exp2(e) * (1 + rng.random((6, P)))).astype(np.float32)
        base[1] = np.abs(base[1])
        base[2, rng.integers(P)] = np.float32(-3.4e38)
        base[3, rng.integers(P)] = TINY
        base[3] = np.abs(base[3])
    else:
        raise AssertionError(kind)
    return base


KINDS = ["ties_in_thread", "ties_across_threads", "signed_zero", "inf",
         "denormals", "exponents"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", PS)
def test_kernel_argmin_equals_argmin(P, kind):
    _check_rows(_rows(kind, P, np.random.default_rng(P * 7 + len(kind))))


def test_keys_order_as_the_floats():
    vals = np.float32([-np.inf, -3.4e38, -1.0, -TINY, -DENORMS[2],
                       -DENORMS[0], -0.0, 0.0, DENORMS[0], DENORMS[2], TINY,
                       1.0, 3.4e38, np.inf])
    keys = T.order_keys(torch.from_numpy(vals)).tolist()
    assert all(0 <= k < 2 ** 32 for k in keys)
    assert keys[6] == keys[7] == 0x80000000      # -0.0 and +0.0 tie
    assert keys[:7] == sorted(set(keys[:7]))     # strictly increasing
    assert keys[7:] == sorted(set(keys[7:]))
    assert keys[0] == 0x007FFFFF and keys[-1] == 0xFF800000


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 128))
def test_kernel_argmin_on_random_finite_rows(seed, P):
    """Rows of random bit patterns (every finite float32 equally likely),
    with a few entries copied over others to make ties."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, (8, P), dtype=np.uint64)
    rows = bits.astype(np.uint32).view(np.float32).copy()
    rows[~np.isfinite(rows)] = 1.0
    rows[4:] = np.abs(rows[4:])
    for i in range(4, 8):
        src = rng.integers(P, size=3)
        rows[i, rng.integers(P, size=3)] = rows[i, src]
    rows[6, rng.integers(P)] = rows[6].min()     # a tie at the minimum
    _check_rows(rows)


def _pairs(kind: str) -> np.ndarray:
    """Float32 values of one kind, every one of them beside each other."""
    rng = np.random.default_rng(len(kind))
    if kind == "normals":
        e = rng.integers(-126, 127, 64).astype(np.float32)
        v = np.exp2(e) * (1 + rng.random(64))
        v = np.where(rng.random(64) < 0.5, -v, v)
    elif kind == "denormals":
        v = np.concatenate([DENORMS, -DENORMS, [TINY, -TINY, 0.0, -0.0]])
    elif kind == "specials":
        v = [-np.inf, np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 1.0, -1.0,
             np.nextafter(np.float32(1), np.float32(2)),
             np.nextafter(np.float32(-1), np.float32(-2))]
    else:
        raise AssertionError(kind)
    v = np.asarray(v, np.float32)
    return np.concatenate([v, v[::3]])           # repeats: equal pairs


@pytest.mark.parametrize("kind", ["normals", "denormals", "specials"])
def test_keys_compare_as_the_floats(kind):
    """For every pair: key(a) < key(b) exactly when a < b, and the keys are
    equal exactly when the floats are (-0.0 == +0.0)."""
    v = _pairs(kind)
    k = T.order_keys(torch.from_numpy(v)).numpy()
    a, b = v[:, None], v[None, :]
    ka, kb = k[:, None], k[None, :]
    np.testing.assert_array_equal(ka < kb, a < b)
    np.testing.assert_array_equal(ka == kb, a == b)


def _recurrence(eff, speed, jitter, h_eff, bcost, forced, count, argmin):
    """The plain core with its argmin replaced."""
    fin = jitter.clone()
    rows = torch.arange(fin.shape[0])
    for i in range(int(count.max())):
        f = forced[:, i].long()
        pe = torch.where(f >= 0, f, argmin(fin))
        inc = torch.addcmul(h_eff, eff[:, i], speed[rows, pe]) + bcost
        cur = fin[rows, pe]
        fin[rows, pe] = torch.where(i < count, cur + inc, cur)
    return fin


@pytest.mark.parametrize("P", [8, 16, 20, 128])
def test_recurrence_on_the_kernels_argmin_equals_plain_core(P):
    """Lanes full of ties (equal jitter, equal costs, unit speeds): the
    recurrence with the kernels' argmin is the plain core, bit for bit."""
    rng = np.random.default_rng(P)
    B, K = 12, 64
    eff = np.where(rng.random((B, K)) < 0.5, 3e-5,
                   rng.random((B, K)) * 1e-4).astype(np.float32)
    jitter = (rng.random((B, P)) * 45e-6).astype(np.float32)
    jitter[::2] = 0.0
    speed = np.ones((B, P), np.float32)
    speed[1::4] = np.clip(1 + 0.01 * rng.standard_normal((3, P)), 0.8, 1.25)
    forced = np.where(rng.random((B, K)) < 0.1,
                      rng.integers(0, P, (B, K)), -1).astype(np.int32)
    count = rng.integers(0, K + 1, B).astype(np.int32)
    count[0] = K
    args = [torch.from_numpy(a) for a in (
        eff, speed, jitter, np.full(B, 0.2e-6, np.float32),
        np.where(np.arange(B) % 3 == 0, 2e-6, 0).astype(np.float32), forced,
        count)]
    want = T.event_finish_ref(*args)
    assert torch.equal(_recurrence(*args, T.warp_argmin), want)
