"""Chunk schedules of the port (``repro_torch.core.sched``) equal the
reference's ``repro.core.jaxsched`` exactly: every schedulable algorithm and
the StaticSteal replay, on every application's N (STREAM's 2e9 included) at
the paper's thread counts, at the default chunk and at expChunk."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import jaxsched as J  # noqa: E402
from repro.sim import APPLICATIONS, SYSTEMS  # noqa: E402
from repro_torch.core import exp_chunk, sched as S  # noqa: E402

APP_N = {name: cls.N for name, cls in APPLICATIONS.items()}
PS = (20, 56, 128)
#: the reference's buffer; longer schedules compare their first 4096 chunks
MAX_CHUNKS = 4096


@pytest.mark.parametrize("alg", sorted(J.SCHEDULABLE))
@pytest.mark.parametrize("app", sorted(APP_N))
def test_chunk_schedule_equals_reference(app, alg):
    N = APP_N[app]
    for P in PS:
        for cp in (0, exp_chunk(N, P)):
            want, wcount = J.chunk_schedule(alg, N, P, cp,
                                            max_chunks=MAX_CHUNKS)
            got, count = S.chunk_schedule(alg, N, P, cp,
                                          max_chunks=MAX_CHUNKS)
            assert count == int(wcount), (N, P, cp)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("app", sorted(APP_N))
def test_staticsteal_schedule_equals_reference(app):
    N = APP_N[app]
    prof = APPLICATIONS[app]().loops(0)[0]
    for P, system in zip(PS, ("broadwell", "cascadelake", "epyc")):
        sysm = SYSTEMS[system]
        ls = prof.locality_sens
        kw = dict(unit=prof.total / N, h=sysm.h,
                  bcost=prof.memory_bound * sysm.boundary_cost,
                  base_infl=1.0 + ls * sysm.dyn_locality,
                  amp=ls * sysm.loc_amp, c_loc=float(prof.c_loc))
        cp = exp_chunk(N, P)
        want = J.staticsteal_schedule(N, P, cp, max_chunks=MAX_CHUNKS, **kw)
        got = S.staticsteal_schedule(N, P, cp, max_chunks=MAX_CHUNKS, **kw)
        assert got[4] == int(want[4])
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_staticsteal_full_replay_with_steals_equals_reference():
    """A complete replay (every PE drains its range and steals) on a
    locality-sensitive loop, where the float32 available times decide which
    PE is served next."""
    kw = dict(unit=2.3e-6, h=0.2e-6, bcost=1.4e-6, base_infl=1.084,
              amp=5.6, c_loc=64.0)
    for N, P, cp in ((40_000, 56, 7), (1000, 56, 1)):
        want = J.staticsteal_schedule(N, P, cp, max_chunks=8192, **kw)
        got = S.staticsteal_schedule(N, P, cp, max_chunks=8192, **kw)
        assert got[4] == int(want[4]) and got[1][:got[4]].sum() == N
        assert not got[3][:got[4]].all()        # some chunks were stolen
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_chunk_schedule_rejects_beyond_int32():
    for fn in (lambda m, n: m.chunk_schedule(2, n, 20, 0),
               lambda m, n: m.staticsteal_schedule(n, 20, 1)):
        for mod in (J, S):
            with pytest.raises(ValueError, match="exceeds int32"):
                fn(mod, 2**31)


def test_unsupported_algorithm_is_refused():
    with pytest.raises(ValueError, match="StaticSteal"):
        S.chunk_schedule(5, 1000, 8, 0)


def test_fma32_rounds_once():
    """``fma32`` equals a float32 fused multiply-add, including the sums
    that land exactly on a float32 tie after the float64 rounding."""
    import torch
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32)
               for _ in range(3))
    want = torch.addcmul(torch.from_numpy(c), torch.from_numpy(a),
                         torch.from_numpy(b)).numpy()
    got = np.array([S.fma32(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    # a*b = 1 + 2^-24 + 2^-48 exactly; + 2^-24 sits on the float64 grid
    # only after rounding away the 2^-48: fused, the result is 1 + 2^-23
    x = np.float32(1 + 2**-24 * 2)      # 1 + 2^-23
    y = np.float32(1 - 2**-24)
    p = float(x) * float(y)             # 1 + 2^-24 - 2^-47, exact
    c = np.float32(-2**-23 + 2**-24)
    assert S.fma32(x, y, c) == np.float32(p + float(c))
