"""Production serving launcher: continuous batching over real decode steps
on the card, which calibrates the per-token cost of the replica cost model,
then chunk-self-scheduled dispatch with online algorithm selection over the
12-algorithm portfolio (the paper's technique, L3).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 2048 --replicas 16 --selector QLearn --reward LT

The port of ``repro.launch.serve``: every arch of the reference is served
(the dense, MoE, SSM, hybrid and enc-dec families), at ``smoke_reduce``,
as the reference's ``--smoke`` (set by default; no flag clears it).  The
enc-dec family decodes from a zero cache, its cross-attention cache
included, as the reference's launcher does.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCH_NAMES, get_config, smoke_reduce
from ..configs.base import ModelConfig
from ..core import ALGORITHM_NAMES
from ..data import Request, synthetic_requests
from ..device import resolve_device
from ..models import init_decode_cache, init_params
from ..serving import ContinuousBatcher, DispatchSimulator, ReplicaCostModel
from .steps import make_serve_step


def live(cfg: ModelConfig, params: Dict, *, slots: int = 8, device=None,
         requests: Optional[List[Request]] = None,
         cache: Optional[Dict] = None, tokens=None, max_len: int = 256,
         max_steps: int = 200) -> Tuple[Dict, float]:
    """Serve ``requests`` (default: the reference's 24 warm-up requests)
    on ``slots`` slots through ``decode_step``, from ``cache`` and
    ``tokens`` (default: a zero cache of ``max_len`` slots and token 0).
    Returns the batcher's stats and the measured seconds per token."""
    dev = resolve_device(device)
    if cache is None:
        cache = init_decode_cache(cfg, slots, max_len, device=dev)
    if tokens is None:
        tokens = torch.zeros((slots,), dtype=torch.int32, device=dev)
    if requests is None:
        requests = synthetic_requests(24, seed=0, mean_prompt=8,
                                      mean_gen=16)
    batcher = ContinuousBatcher(make_serve_step(cfg), None, slots)
    batcher.submit(requests)
    stats = batcher.run(params, cache, tokens, max_steps=max_steps)
    return stats, stats["wall"] / max(stats["tokens"], 1)


def dispatch(per_tok: float, *, requests: int = 2048, replicas: int = 16,
             selector: str = "QLearn", reward: str = "LT", backend=None
             ) -> Tuple[Dict, Dict[int, int]]:
    """The scale path: ``requests`` heavy-tailed requests dispatched in
    waves over ``replicas`` replicas, each wave's algorithm chosen by
    ``selector``, under a cost model of ``per_tok / 50`` seconds a token.
    ``backend`` prices the waves of a simulation-assisted selector (None:
    the batched engine on the card).  Returns the simulator's summary and
    the number of waves each algorithm ran."""
    reqs = synthetic_requests(requests, seed=7, heavy_tail=1.15)
    sim = DispatchSimulator(replicas, selector=selector, reward=reward,
                            cost_model=ReplicaCostModel(
                                per_token=per_tok / 50),
                            backend=backend)
    sim.run(reqs)
    shares: Dict[int, int] = {}
    for st in sim.stats:
        shares[st.algorithm] = shares.get(st.algorithm, 0) + 1
    return sim.summary(), shares


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--replicas", type=int, default=16)
    ap.add_argument("--selector", default="QLearn")
    ap.add_argument("--reward", default="LT")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    cfg = smoke_reduce(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    params = init_params(cfg, 0)
    stats, per_tok = live(cfg, params, slots=args.slots)
    print(f"live: {stats['tokens_per_s']:.0f} tok/s on {args.slots} slots "
          f"({cfg.family}); per-token {per_tok * 1e6:.0f} us")

    s, shares = dispatch(per_tok, requests=args.requests,
                         replicas=args.replicas, selector=args.selector,
                         reward=args.reward)
    top = max(shares, key=shares.get)
    print(f"dispatch[{args.selector}/{args.reward}]: "
          f"makespan={s['total_makespan']:.3f}s mean LIB={s['mean_lib']:.1f}% "
          f"waves={s['waves']} mostly->{ALGORITHM_NAMES[top]}")


if __name__ == "__main__":
    main()
