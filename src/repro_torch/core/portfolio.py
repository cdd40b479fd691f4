"""The 12-algorithm scheduling portfolio of LB4OMP / Auto4OMP (paper §2, §3.1)
— the port's copy of ``repro.core.portfolio``.

Each algorithm computes *chunk sizes* — how many loop iterations a
processing element (PE) self-assigns per work request.  The stateful host
classes (``ChunkAlgorithm`` subclasses) drive the Python event-loop engine
(``repro_torch.sim.backends.python``), where the *adaptive* algorithms get
per-PE runtime telemetry; the batched engine takes its schedules from
``repro_torch.core.sched`` instead.

The portfolio order matches Table 2's footnote:

    [STATIC, SS, GSS, Auto(LLVM), TSS, StaticSteal,
     mFAC2, AWF-B, AWF-C, AWF-D, AWF-E, mAF]

Chunk-parameter semantics (paper §2, "Significance of the chunk parameter"):
for STATIC and SS the user chunk sets the size *directly*; for every other
algorithm it is a floor: ``delivered = max(algorithm, user)``.  Chunks never
exceed the remaining iterations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

ALGORITHM_NAMES: List[str] = [
    "STATIC",       # 0  OpenMP static (or static,chunk when a param is given)
    "SS",           # 1  self-scheduling / OpenMP dynamic    [Peiyi&Yen 86]
    "GSS",          # 2  guided self-scheduling              [Polychronopoulos&Kuck 87]
    "AutoLLVM",     # 3  LLVM schedule(auto) heuristic
    "TSS",          # 4  trapezoid self-scheduling           [Tzen&Ni 93]
    "StaticSteal",  # 5  static + work stealing              [Blumofe&Leiserson 99]
    "mFAC2",        # 6  practical factoring, atomic-counter variant [Hummel 92 / LB4OMP]
    "AWF_B",        # 7  adaptive weighted factoring, batched       [Banicescu 03]
    "AWF_C",        # 8  AWF, chunked (recompute per request)
    "AWF_D",        # 9  AWF-B with total-chunk-time weights
    "AWF_E",        # 10 AWF-C with total-chunk-time weights
    "mAF",          # 11 adaptive factoring, practical variant      [Banicescu&Liu 00]
]

N_ALGORITHMS = len(ALGORITHM_NAMES)

# Indices of algorithms whose chunk calculation *adapts* to measured PE speed.
ADAPTIVE_SET = frozenset({7, 8, 9, 10, 11})
# Algorithms where the user chunk parameter sets the size directly.
DIRECT_CHUNK_SET = frozenset({0, 1})

GOLDEN_RATIO = (1.0 + math.sqrt(5.0)) / 2.0  # phi = 1.618...


def alg_index(name: str) -> int:
    return ALGORITHM_NAMES.index(name)


def exp_chunk(N: int, P: int) -> int:
    """expChunk: golden-ratio point on the curve {N/(2^i P)} between N/(2P) and 1.

    Candidate chunk parameters are N/(2P), N/(4P), ... down to 1 (i in steps of
    2^n).  expChunk sits at 1/phi = 0.618 of the way along that curve, i.e. at
    exponent i = round((1 - 1/phi) * log2(N/P)).  For the paper's running
    example (N=1e6, P=20) this yields 781 — one of the two chunk parameters
    highlighted in Figs. 1-2.
    """
    if N <= 0 or P <= 0:
        raise ValueError("N and P must be positive")
    ratio = max(2.0, N / P)
    k_max = math.log2(ratio)  # exponent at which chunk reaches 1
    i = round((1.0 - 1.0 / GOLDEN_RATIO) * k_max)
    i = max(1, i)
    return max(1, int(N // (2 ** i * P)))


def apply_chunk_floor(alg: int, computed: int, chunk_param: int, remaining: int) -> int:
    """LB4OMP chunk-parameter semantics, clipped to the remaining iterations."""
    if remaining <= 0:
        return 0
    if alg in DIRECT_CHUNK_SET and chunk_param > 0:
        out = chunk_param
    else:
        out = max(computed, max(1, chunk_param))
    return int(max(1, min(out, remaining)))
# ---------------------------------------------------------------------------
# Stateful algorithm classes
# ---------------------------------------------------------------------------


@dataclass
class ChunkAlgorithm:
    """Base class. Lifecycle:

        alg.reset(N, P, chunk_param)
        while work remains:
            c = alg.next_chunk(pe)          # pe = requesting PE id
            ... execute c iterations ...
            alg.report(pe, c, iters_time, chunk_time)
    """

    name: str = "base"
    index: int = -1
    adaptive: bool = False

    def reset(self, N: int, P: int, chunk_param: int = 0) -> None:
        self.N = int(N)
        self.P = int(P)
        self.chunk_param = int(chunk_param)
        self.remaining = int(N)
        self.scheduled = 0
        self._reset_impl()

    def _reset_impl(self) -> None:  # pragma: no cover - overridden
        pass

    def next_chunk(self, pe: int) -> int:
        if self.remaining <= 0:
            return 0
        c = apply_chunk_floor(self.index, self._compute(pe), self.chunk_param,
                              self.remaining)
        self.remaining -= c
        self.scheduled += c
        return c

    def _compute(self, pe: int) -> int:  # pragma: no cover - overridden
        raise NotImplementedError

    def report(self, pe: int, chunk: int, iters_time: float,
               chunk_time: float) -> None:
        """Telemetry hook: ``iters_time`` is the pure iteration execution time,
        ``chunk_time`` additionally includes scheduling overhead (AWF-D/E)."""

    # ---- static-family helpers -------------------------------------------
    def is_static(self) -> bool:
        return False


class Static(ChunkAlgorithm):
    """Eq. 1: P equal chunks, pre-assigned.  With a chunk parameter this is
    ``schedule(static, chunk)``: round-robin fixed-size chunks."""

    def __init__(self) -> None:
        self.name, self.index = "STATIC", 0

    def _compute(self, pe: int) -> int:
        if self.chunk_param > 0:
            return self.chunk_param
        # ceil(N/P) so that P chunks always cover N
        return -(-self.N // self.P)

    def is_static(self) -> bool:
        return True


class SelfScheduling(ChunkAlgorithm):
    """SS, Eq. 2: chunk = 1 (or the user chunk — OpenMP ``dynamic,chunk``)."""

    def __init__(self) -> None:
        self.name, self.index = "SS", 1

    def _compute(self, pe: int) -> int:
        return 1


class GuidedSS(ChunkAlgorithm):
    """GSS, Eq. 3: Cs_i = ceil(R_i / P)."""

    def __init__(self) -> None:
        self.name, self.index = "GSS", 2

    def _compute(self, pe: int) -> int:
        return -(-self.remaining // self.P)


class AutoLLVM(ChunkAlgorithm):
    """LLVM ``schedule(auto)``: guided-analytical heuristic.  Modeled (per
    LLVM's kmp guided_analytical_chunked) as guided with a doubled divisor and
    a parallelism-derived minimum quantum — DESIGN.md §8 notes the source.
    """

    def __init__(self) -> None:
        self.name, self.index = "AutoLLVM", 3

    def _reset_impl(self) -> None:
        # LLVM uses a minimum chunk targeting ~4 chunks per PE tail.
        self._min_quantum = max(1, self.N // (self.P * self.P * 4))

    def _compute(self, pe: int) -> int:
        guided = -(-self.remaining // (2 * self.P))
        return max(self._min_quantum, guided)


class Trapezoid(ChunkAlgorithm):
    """TSS, Eq. 4 with the recommended f = N/(2P), l = 1.

    Chunk k is ceil(f - k*delta) with delta = (f-1)/(A-1), evaluated in
    exact integer arithmetic (chunk_k = ceil((N*(A-1) - k*(N-2P)) /
    (2P*(A-1)))) so the sequence is bit-identical to the pure-JAX
    ``chunk_schedule`` — float64 running subtraction drifts past exact
    integer crossings and used to produce platform-hostage +-1 chunks.
    """

    def __init__(self) -> None:
        self.name, self.index = "TSS", 4

    def _reset_impl(self) -> None:
        self._k = 0
        twoP = 2 * self.P
        if self.N < twoP:          # f clamps to 1 -> delta 0 -> unit chunks
            self._Am1 = 0
            return
        # A = ceil(2N/(f+1)) = ceil(4PN/(N+2P)) = 4P - floor(8P^2/(N+2P))
        A = 4 * self.P - (8 * self.P * self.P) // (self.N + twoP)
        self._Am1 = max(1, A - 1)
        self._D = twoP * self._Am1

    def _compute(self, pe: int) -> int:
        if self._Am1 == 0:
            return 1
        k = min(self._k, self._Am1)
        self._k += 1
        num = self.N * self._Am1 - k * (self.N - 2 * self.P)
        return max(1, -(-num // self._D))


class StaticSteal(ChunkAlgorithm):
    """Static pre-split into P ranges; an idle PE steals half of the richest
    victim's remainder.  Chunks are delivered in sub-chunks of the steal
    quantum so the simulator sees individual work requests."""

    def __init__(self) -> None:
        self.name, self.index = "StaticSteal", 5

    def _reset_impl(self) -> None:
        base = self.N // self.P
        extra = self.N % self.P
        self.local = [base + (1 if i < extra else 0) for i in range(self.P)]
        # LLVM static_steal dispenses the local range one chunk at a time;
        # the default chunk is 1 iteration (the paper's STREAM blowup)
        self.quantum = max(1, self.chunk_param)

    def _compute(self, pe: int) -> int:
        if self.local[pe] <= 0:
            victim = max(range(self.P), key=lambda i: self.local[i])
            if self.local[victim] <= 0:
                return 1  # nothing to steal; floor clips vs remaining
            stolen = -(-self.local[victim] // 2)
            self.local[victim] -= stolen
            self.local[pe] += stolen
        c = min(self.quantum, self.local[pe])
        self.local[pe] -= c
        return c


class MFac2(ChunkAlgorithm):
    """mFAC2 (practical factoring, x=2): batches of P chunks, each batch
    assigns half of the remaining iterations.  Atomic-counter variant — same
    chunk sizes as FAC2, lower overhead (modeled via the system's h)."""

    def __init__(self) -> None:
        self.name, self.index = "mFAC2", 6

    def _reset_impl(self) -> None:
        self._counter = 0  # atomic chunk counter
        self._batch_j = 0
        self._batch_R = self.N
        self._batch_cs = -(-self.N // (2 * self.P))

    def _compute(self, pe: int) -> int:
        j = self._counter // self.P
        # chunk size for batch j: R_j / (2P), R_{j+1} = R_j - P*Cs_j
        while self._batch_j < j:
            self._batch_R -= self.P * self._batch_cs
            self._batch_cs = max(0, -(-self._batch_R // (2 * self.P)))
            self._batch_j += 1
        self._counter += 1
        return max(1, self._batch_cs)


class _AWFBase(ChunkAlgorithm):
    """Adaptive weighted factoring (Banicescu et al. 03) — four variants.

    Weights are the normalized inverse of each PE's measured time-per-
    iteration (variants B/C) or total-chunk time-per-iteration including
    scheduling overhead (variants D/E).  B/D are *batched* (weights frozen
    within a batch); C/E are *chunked* (weights + batch recomputed on every
    work request).
    """

    batched = True
    total_time = False
    adaptive = True

    def _reset_impl(self) -> None:
        import numpy as _np
        self.w = _np.ones(self.P)                # PE weights, mean 1
        self._pe_time = _np.zeros(self.P)        # cumulated timing numerator
        self._pe_iters = _np.zeros(self.P)       # cumulated iterations
        self._batch_left = 0                     # chunks left in current batch
        self._batch_cs = 0
        self._dirty = False

    def report(self, pe, chunk, iters_time, chunk_time):
        t = chunk_time if self.total_time else iters_time
        self._pe_time[pe] += max(t, 1e-12)
        self._pe_iters[pe] += chunk
        if self.batched:
            self._dirty = True       # weights refresh at the batch boundary
        else:
            self._update_weights()   # chunked variants: every request

    def _update_weights(self) -> None:
        import numpy as _np
        # weighted average performance: rate_i = iters_i / time_i
        known = self._pe_iters > 0
        if not known.any():
            return
        rates = _np.where(known, self._pe_iters / _np.maximum(self._pe_time, 1e-30), 0.0)
        mean_rate = rates[known].mean()
        raw = _np.where(known, rates, mean_rate)
        total = raw.sum()
        if total <= 0:
            return
        self.w = self.P * raw / total
        self._dirty = False

    def _compute(self, pe: int) -> int:
        if self.batched:
            if self._batch_left <= 0:
                if self._dirty:
                    self._update_weights()
                self._batch_cs = -(-self.remaining // (2 * self.P))
                self._batch_left = self.P
            self._batch_left -= 1
            base = self._batch_cs
        else:
            base = -(-self.remaining // (2 * self.P))
        return max(1, int(round(self.w[pe] * base)))


class AWF_B(_AWFBase):
    def __init__(self) -> None:
        self.name, self.index = "AWF_B", 7
        self.batched, self.total_time = True, False


class AWF_C(_AWFBase):
    def __init__(self) -> None:
        self.name, self.index = "AWF_C", 8
        self.batched, self.total_time = False, False


class AWF_D(_AWFBase):
    def __init__(self) -> None:
        self.name, self.index = "AWF_D", 9
        self.batched, self.total_time = True, True


class AWF_E(_AWFBase):
    def __init__(self) -> None:
        self.name, self.index = "AWF_E", 10
        self.batched, self.total_time = False, True


class MAdaptiveFactoring(ChunkAlgorithm):
    """mAF (adaptive factoring, Eqs. 6-7): per-PE mu_i, sigma_i estimated
    online; D_n = sum(sigma_i^2/mu_i), T_n = (sum 1/mu_i)^-1,
    Cs_i = (D + 2 T R - sqrt(D^2 + 4 D T R)) / (2 mu_i); first chunk >= 100.
    """

    adaptive = True

    def __init__(self) -> None:
        self.name, self.index = "mAF", 11

    def _reset_impl(self) -> None:
        import numpy as _np
        self._sum_t = _np.zeros(self.P)    # sum of per-iteration times
        self._sum_t2 = _np.zeros(self.P)   # sum of squared per-iteration times
        self._cnt = _np.zeros(self.P)      # chunks reported (mu over chunk means)
        self._have_stats = False

    def report(self, pe, chunk, iters_time, chunk_time):
        if chunk <= 0:
            return
        per_iter = max(iters_time / chunk, 1e-12)
        self._sum_t[pe] += per_iter
        self._sum_t2[pe] += per_iter * per_iter
        self._cnt[pe] += 1
        self._have_stats = True

    def _mu_sigma_all(self):
        import numpy as _np
        known = self._cnt > 0
        tot = self._cnt.sum()
        g_mu = self._sum_t.sum() / tot
        g_var = max(0.0, self._sum_t2.sum() / tot - g_mu * g_mu)
        mu = _np.where(known, self._sum_t / _np.maximum(self._cnt, 1), g_mu)
        ex2 = _np.where(known, self._sum_t2 / _np.maximum(self._cnt, 1),
                        g_var + g_mu * g_mu)
        var = _np.maximum(0.0, ex2 - mu * mu)
        return mu, var

    def _compute(self, pe: int) -> int:
        if not self._have_stats:
            # Eq. 6: Cs^(1) >= 100 for the very first, statistics-free chunks
            return min(100, max(1, self.remaining // self.P))
        mu, var = self._mu_sigma_all()
        # Eq. 7: D = sum(sigma_i^2 / mu_i), T = (sum 1/mu_i)^-1
        D = float((var / mu).sum())
        invmu_sum = float((1.0 / mu).sum())
        if invmu_sum <= 0:
            return max(1, self.remaining // (2 * self.P))
        T = 1.0 / invmu_sum
        R = float(self.remaining)
        mu_pe = float(mu[pe])
        num = D + 2.0 * T * R - math.sqrt(D * D + 4.0 * D * T * R)
        cs = num / (2.0 * mu_pe) if mu_pe > 0 else R / (2.0 * self.P)
        return max(1, int(cs))


_FACTORIES = [Static, SelfScheduling, GuidedSS, AutoLLVM, Trapezoid,
              StaticSteal, MFac2, AWF_B, AWF_C, AWF_D, AWF_E,
              MAdaptiveFactoring]


def make_algorithm(idx_or_name) -> ChunkAlgorithm:
    idx = idx_or_name if isinstance(idx_or_name, int) else alg_index(idx_or_name)
    a = _FACTORIES[idx]()
    assert a.index == idx, (a.index, idx)
    return a


def make_portfolio() -> List[ChunkAlgorithm]:
    return [make_algorithm(i) for i in range(N_ALGORITHMS)]
