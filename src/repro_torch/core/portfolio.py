"""The 12-algorithm scheduling portfolio of LB4OMP / Auto4OMP (paper §2, §3.1)
— the part the batched simulator needs: the algorithm names and sets, the
expert chunk parameter and the chunk-parameter floor.

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
