"""Chunk-size schedules of the scheduling portfolio — the port's counterpart
of ``repro.core.jaxsched``, as exact host-side integer recurrences.

``chunk_schedule(alg, N, P, chunk_param, max_chunks)`` returns the sequence of
chunk sizes a central work queue would deliver:

    STATIC(0)  SS(1)  GSS(2)  AutoLLVM(3)  TSS(4)  mFAC2(6)

and, for the *adaptive* algorithms, the telemetry-free surrogate recurrences
(the exact sequence the host classes emit under constant per-iteration cost,
weights pinned at 1):

    AWF-B/D(7,9)  batches of P chunks, each batch Cs = ceil(R/2P)
    AWF-C/E(8,10) Cs = ceil(R/2P) recomputed per request
    mAF(11)       first chunk min(100, N//P), then Cs = R//P

``staticsteal_schedule`` replays StaticSteal's quantum serving + half-stealing
event loop (noise-free, uniform cost) and yields explicit (start, size, pe)
triples, since stolen chunks are not contiguous in iteration space.

``weighted_adaptive_schedule`` emits the adaptive algorithms' schedules at a
converged, non-uniform weight vector (perturbed or heterogeneous PE speeds),
with every chunk forced to the PE that requests it.

The recurrences run on Python integers, so they cannot wrap; N is still held
to int32 (``ValueError`` above ``2**31 - 1``), the range the reference
accepts with 64-bit integers off.  The StaticSteal replay keeps the PEs'
available times in float32 with the reference's operation order (the
per-chunk time ``h + c*unit*locf`` contracts to one fused multiply-add, as
XLA emits it), so near-ties pick the same PE.
"""

from __future__ import annotations

import math

import numpy as np

from .portfolio import DIRECT_CHUNK_SET

INT32_MAX = 2**31 - 1

#: algorithms chunk_schedule can emit (5 = StaticSteal has its own function)
SCHEDULABLE = frozenset({0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11})


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_int32(fn: str, N: int) -> None:
    if N > INT32_MAX:
        raise ValueError(f"{fn}: N={N} exceeds int32")


def chunk_schedule(alg: int, N: int, P: int, chunk_param: int,
                   max_chunks: int = 4096):
    """Returns (sizes[max_chunks] int32, count int).

    sizes[i] is the i-th delivered chunk; zeros beyond ``count``.  The floor
    semantics match ``apply_chunk_floor``: for STATIC/SS the user chunk sets
    the size directly; otherwise ``max(algorithm, max(1, chunk_param))``;
    always clipped by the remaining iterations.
    """
    if alg not in SCHEDULABLE:
        raise ValueError(
            f"chunk_schedule: unsupported algorithm {alg} "
            "(StaticSteal needs staticsteal_schedule)")
    N, P, cp = int(N), int(P), int(chunk_param)
    _check_int32("chunk_schedule", N)
    out = np.zeros(max_chunks, np.int32)
    if alg in DIRECT_CHUNK_SET:
        # constant chunks: STATIC ceil(N/P), SS 1, or the user's chunk
        c = cp if cp > 0 else (_ceil_div(N, P) if alg == 0 else 1)
        c = max(c, 1)
        full, rest = divmod(N, c)
        count = min(full + (rest > 0), max_chunks)
        out[:count] = c
        if rest and count == full + 1:
            out[count - 1] = rest
        return out, count
    sizes = _recurrence(alg, N, P, cp, max_chunks)
    out[:len(sizes)] = sizes
    return out, len(sizes)


def _recurrence(alg: int, N: int, P: int, cp: int, max_chunks: int) -> list:
    """Chunk sizes of a non-constant algorithm, one Python step per chunk."""
    floor = max(1, cp)
    twoP = 2 * P
    if alg == 3:
        quantum = max(1, N // (P * P * 4))
    elif alg == 4:
        # TSS (Eq. 4, f = N/(2P), l = 1): chunk_k = ceil(f - k*delta) with
        # delta = (f-1)/(A-1), i.e. ceil((N*Am1 - k*(N-2P)) / (2P*Am1)),
        # in the reference's split form (exact for any int32 N)
        tss_small = N < twoP
        A = 4 * P - (8 * P * P) // (N + twoP)
        Am1 = max(1, A - 1)
        tss_D = twoP * Am1
        a1, b1 = divmod(N, tss_D)
        a2, b2 = divmod(max(0, N - twoP), tss_D)
    elif alg == 11:
        first_maf = min(100, max(1, N // P))
    # recurrence state (s0, s1, s2); meaning depends on alg
    if alg == 6:
        # mFAC2: s0 = chunks left in batch, s1 = batch Cs, s2 = batch R
        s0, s1, s2 = P, _ceil_div(N, twoP), N
    else:
        # AWF-B/D start with s0 = 0 so their first request opens a batch
        s0 = s1 = s2 = 0
    sizes: list = []
    remaining = N
    while remaining > 0 and len(sizes) < max_chunks:
        if alg == 2:        # GSS: ceil(R/P)
            raw = _ceil_div(remaining, P)
        elif alg == 3:      # AutoLLVM: guided/2P with quantum
            raw = max(quantum, _ceil_div(remaining, twoP))
        elif alg == 4:      # TSS: linear decrement, exact rational arithmetic
            k = min(len(sizes), Am1)
            raw = (a1 * Am1 - k * a2) + _ceil_div(b1 * Am1 - k * b2, tss_D)
            raw = 1 if tss_small else max(1, raw)
        elif alg == 6:      # mFAC2: batches of P chunks, R_{j+1} = R_j - P*Cs_j
            if s0 <= 0:
                s2 -= P * s1
                s1 = max(0, _ceil_div(s2, twoP))
                s0 = P - 1
            else:
                s0 -= 1
            raw = max(1, s1)
        elif alg in (7, 9):     # AWF-B/D surrogate: batched factoring, w = 1
            if s0 <= 0:
                s1 = _ceil_div(remaining, twoP)
                s0 = P - 1
            else:
                s0 -= 1
            raw = max(1, s1)
        elif alg in (8, 10):    # AWF-C/E surrogate: chunked factoring, w = 1
            raw = max(1, _ceil_div(remaining, twoP))
        else:                   # mAF surrogate: mu constant, sigma 0 -> R/P
            raw = first_maf if not sizes else max(1, remaining // P)
        c = min(max(raw, floor), remaining)
        sizes.append(c)
        remaining -= c
    return sizes


# ---------------------------------------------------------------------------
# StaticSteal: quantum serving + half-stealing, explicit (start, size, pe)
# ---------------------------------------------------------------------------

def fma32(a, b, c) -> np.float32:
    """float32 ``a*b + c`` rounded once, as a fused multiply-add.

    The float64 product of two float32 values is exact, so the float64 sum
    is rounded twice in all; where that second rounding meets an exact
    float32 tie, the sum's exact error (TwoSum) settles the direction."""
    p = float(np.float32(a)) * float(np.float32(b))
    c = float(np.float32(c))
    s = p + c
    r = np.float32(s)
    if float(r) == s or not math.isfinite(s):
        return r
    other = np.nextafter(r, np.float32(math.copysign(np.inf, s - float(r))))
    if (float(r) + float(other)) * 0.5 != s:
        return r                                # not a tie: r is right
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err == 0.0:
        return r                                # an exact tie: to even
    return max(r, other) if err > 0.0 else min(r, other)


def staticsteal_schedule(N: int, P: int, chunk_param: int,
                         max_chunks: int = 4096, unit: float = 1.0,
                         h: float = 0.0, bcost: float = 0.0,
                         base_infl: float = 1.0, amp: float = 0.0,
                         c_loc: float = 64.0):
    """Replay StaticSteal's event loop (noise-free, per-iteration cost
    ``unit``) and return the delivered schedule.

    Returns ``(starts, sizes, pes, own, count)`` — ``(max_chunks,)`` buffers
    (int32, int32, int32, bool) plus the live count.  ``own[i]`` marks
    chunks served from the PE's original range (no locality penalty).  Serve
    order replays the argmin-over-available-times policy (ties to the lowest
    PE), and a PE whose range is empty steals the back half of the first
    richest victim.
    """
    N, P = int(N), int(P)
    _check_int32("staticsteal_schedule", N)
    bounds = np.linspace(0, N, P + 1).round().astype(np.int64)
    q = max(1, int(chunk_param))
    f32 = np.float32
    unit, h, bcost = f32(unit), f32(h), f32(bcost)
    base_infl, amp, c_loc = f32(base_infl), f32(amp), f32(c_loc)
    amp_cl = amp * c_loc
    lo = bounds[:-1].copy()
    hi = bounds[1:].copy()
    avail = np.zeros(P, f32)
    starts = np.zeros(max_chunks, np.int32)
    sizes = np.zeros(max_chunks, np.int32)
    pes = np.zeros(max_chunks, np.int32)
    own = np.zeros(max_chunks, bool)
    remaining = N
    i = 0
    while remaining > 0 and i < max_chunks:
        pe = int(np.argmin(avail))
        if lo[pe] >= hi[pe]:
            victim = int(np.argmax(hi - lo))
            vh = int(hi[victim])
            half = (vh - int(lo[victim]) + 1) // 2
            hi[victim] = vh - half
            lo[pe], hi[pe] = vh - half, vh
        lo_pe = int(lo[pe])
        c = min(q, int(hi[pe]) - lo_pe)
        is_own = bool(bounds[pe] <= lo_pe < bounds[pe + 1])
        cf = f32(c)
        locf = f32(1.0) if is_own else base_infl + amp_cl / (cf + c_loc)
        avail[pe] += fma32(cf * unit, locf, h) + bcost
        lo[pe] = lo_pe + c
        starts[i], sizes[i], pes[i], own[i] = lo_pe, c, pe, is_own
        remaining -= c
        i += 1
    return starts, sizes, pes, own, i


# ---------------------------------------------------------------------------
# weighted adaptive surrogates (the two-pass re-estimation's second pass)
# ---------------------------------------------------------------------------

#: adaptive algorithms the weighted surrogate covers (AWF-B/C/D/E, mAF)
ADAPTIVE_SCHEDULABLE = frozenset({7, 8, 9, 10, 11})


def weighted_adaptive_schedule(alg: int, N: int, P: int, chunk_param: int,
                               weights):
    """Chunk schedule of an adaptive algorithm at a *converged weight
    vector* — the second pass of the adaptive-surrogate scheme.

    The telemetry-free surrogates above pin every AWF/mAF weight at 1,
    which is exact only when per-PE rates are homogeneous.  Under PE
    slowdowns / heterogeneous systems the host classes converge to
    mean-1-normalized inverse time-per-iteration weights and deliver
    ``max(1, round(w[pe] * Cs))`` to each requesting PE; this emits that
    fixed-point sequence directly (simulate -> re-estimate weights from the
    perturbed rate table -> re-simulate), host-side in numpy.

    Because weighted chunk sizes are *per-PE*, the assignment is part of
    the schedule: returns ``(sizes int64, pes int32)`` with every chunk
    force-assigned to its requesting PE (fastest PEs request first within a
    batch — they drain their chunks soonest).  At ``weights == 1`` the
    sizes reduce to the unweighted surrogate recurrences.
    """
    if alg not in ADAPTIVE_SCHEDULABLE:
        raise ValueError(f"weighted_adaptive_schedule: {alg} is not an "
                         f"adaptive algorithm ({sorted(ADAPTIVE_SCHEDULABLE)})")
    w = np.asarray(weights, np.float64)
    if w.shape != (P,) or not np.all(w > 0):
        raise ValueError("weights must be a positive (P,) vector")
    order = [int(p) for p in np.argsort(-w, kind="stable")]
    floor = max(1, int(chunk_param))
    sizes: list = []
    pes: list = []
    R = int(N)
    if alg == 11:               # mAF: probe chunk, then Cs = R // P
        probe = min(100, max(1, R // P))
        c = min(R, max(probe, floor))
        sizes.append(c)
        pes.append(order[0])
        R -= c
        while R > 0:
            for p in order:
                if R <= 0:
                    break
                raw = max(1, int(round((R // P) * w[p])))
                c = min(R, max(raw, floor))
                sizes.append(c)
                pes.append(p)
                R -= c
    else:                       # AWF-B/D batched, AWF-C/E per-request
        per_request = alg in (8, 10)
        while R > 0:
            Cs = -(-R // (2 * P))
            for p in order:
                if R <= 0:
                    break
                if per_request:
                    Cs = -(-R // (2 * P))
                raw = max(1, int(round(Cs * w[p])))
                c = min(R, max(raw, floor))
                sizes.append(c)
                pes.append(p)
                R -= c
    return np.asarray(sizes, np.int64), np.asarray(pes, np.int32)
