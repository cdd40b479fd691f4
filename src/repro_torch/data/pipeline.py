"""Synthetic serving requests: Pareto-tailed prompt and generation lengths
with Poisson arrivals, each field from its own named substream.

The port's own numpy copy of the request half of
``repro.data.pipeline``; it yields the reference's requests field for
field.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Request:
    rid: int
    prompt_len: int
    gen_len: int
    arrival: float


def field_rng(seed: int, fieldname: str) -> np.random.Generator:
    """Named per-field RNG substream: ``(seed, crc32(field))`` entropy, the
    same stable-digest convention as ``SelectionService`` region seeds.

    Request generators draw every field (prompt lengths, gen lengths,
    arrival gaps) from its own substream so that adding, resizing, or
    re-parameterizing one field can never perturb the draws of another —
    ``synthetic_requests(2 * n)[:n]`` extends a workload without rewriting
    its history."""
    digest = zlib.crc32(fieldname.encode("utf-8"))
    return np.random.default_rng((int(seed), digest))


def request_lengths(n: int, seed: int, mean_prompt: int, mean_gen: int,
                    heavy_tail: float) -> Tuple[np.ndarray, np.ndarray]:
    """Pareto-tailed (prompt, gen) token counts — the 'iteration cost
    imbalance' source of the serving adaptation — drawn from the ``prompt``
    and ``gen`` field substreams (independent of any arrival process laid
    on top)."""
    prompts = np.minimum(
        (field_rng(seed, "prompt").pareto(heavy_tail, n) + 1.0)
        * mean_prompt * 0.4, 16384).astype(int) + 8
    gens = np.minimum(
        (field_rng(seed, "gen").pareto(heavy_tail, n) + 1.0)
        * mean_gen * 0.4, 4096).astype(int) + 4
    return prompts, gens


def synthetic_requests(n: int, seed: int = 0, mean_prompt: int = 512,
                       mean_gen: int = 128, heavy_tail: float = 1.3,
                       arrival_rate: float = 64.0,
                       arrivals: Optional[np.ndarray] = None
                       ) -> List[Request]:
    """Heterogeneous serving workload: Pareto-tailed prompt/gen lengths with
    Poisson arrivals (or caller-supplied ``arrivals`` — the fleet trace
    generators inject bursty/diurnal processes here).

    Each field draws from its own named substream (:func:`field_rng`), so
    prompt, gen, and arrival draws are mutually independent: resizing or
    re-parameterizing one field leaves the others bit-identical, and the
    per-seed streams are pinned by a golden regression test
    (``tests/test_fleet.py::test_synthetic_requests_golden``)."""
    prompts, gens = request_lengths(n, seed, mean_prompt, mean_gen,
                                    heavy_tail)
    if arrivals is None:
        arrivals = np.cumsum(
            field_rng(seed, "arrival").exponential(1.0 / arrival_rate, n))
    elif len(arrivals) != n:
        raise ValueError(f"arrivals has {len(arrivals)} entries for {n} "
                         "requests")
    return [Request(i, int(p), int(g), float(a))
            for i, (p, g, a) in enumerate(zip(prompts, gens, arrivals))]
