"""Deterministic synthetic data: the training token stream with O(1)
resume, the enc-dec family's stub frame embeddings, and serving requests
(Pareto-tailed prompt and generation lengths with Poisson arrivals, each
field from its own named substream).

The port's own numpy copy of ``repro.data.pipeline``; it yields the
reference's batches bit for bit and its requests field for field.  Every
training batch is a pure function of ``(seed, step)``: after a checkpoint
restore at step k, ``batch_at(k)`` yields the same data with no stream
replay.  The frames (``frames_at``) are the port's own: the reference's
pipeline has none, so its trainer cannot train the enc-dec family.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

#: the tag of the frame stream's generator (``TokenPipeline.frames_at``)
FRAMES_TAG = zlib.crc32(b"embeds")


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic mixture: (name, weight, zipf exponent) per corpus
    mixture: Tuple[Tuple[str, float, float], ...] = (
        ("web", 0.6, 1.2), ("code", 0.3, 1.05), ("math", 0.1, 1.4))


class TokenPipeline:
    """Step-indexed synthetic token stream (a mixture of zipf-ish corpora);
    ``batch_at(step)`` returns int32 ``tokens`` and next-token ``labels``
    of shape (global_batch, seq_len)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        w = np.array([m[1] for m in cfg.mixture])
        self._weights = w / w.sum()
        self._exps = [m[2] for m in cfg.mixture]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        corpus = rng.choice(len(self._weights), size=cfg.global_batch,
                            p=self._weights)
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        for i, c in enumerate(corpus):
            # zipf-ish marginal per corpus, shifted into the vocab
            r = rng.random((cfg.seq_len + 1,))
            z = np.floor((cfg.vocab_size - 1) * r ** self._exps[c])
            toks[i] = z.astype(np.int32) % cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def frames_at(self, step: int, encoder_seq: int,
                  d_model: int) -> np.ndarray:
        """The enc-dec family's stub frame embeddings of ``step``: standard
        normal float32 of shape (global_batch, encoder_seq, d_model), what
        the stubbed audio front end hands the encoder.  They come from a
        generator of their own, keyed by ``(seed, step, FRAMES_TAG)``, so
        ``batch_at``'s tokens are untouched and a restart at step k draws
        the same frames again."""
        rng = np.random.default_rng((self.cfg.seed, step, FRAMES_TAG))
        return rng.standard_normal(
            (self.cfg.global_batch, encoder_seq, d_model), dtype=np.float32)

    def train_batch_at(self, step: int, model_cfg) -> Dict[str, np.ndarray]:
        """The batch a model of ``model_cfg`` trains on at ``step``:
        ``batch_at``'s tokens and labels and, for the enc-dec family, the
        step's frames (``embeds``, at its encoder length and width)."""
        batch = self.batch_at(step)
        if model_cfg.family == "encdec":
            batch["embeds"] = self.frames_at(step, model_cfg.encoder_seq,
                                             model_cfg.d_model)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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
