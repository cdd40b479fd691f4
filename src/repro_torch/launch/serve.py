"""Serving launcher, live half: continuous batching over real decode steps
on the card, which calibrates the per-token cost of the replica cost model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --smoke

The port of the live path of ``repro.launch.serve``; its dispatch half
(selection over the 12-algorithm dispatch portfolio) waits for the
dispatcher's slice (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCH_NAMES, get_config, smoke_reduce
from ..configs.base import ModelConfig
from ..data import Request, synthetic_requests
from ..device import resolve_device
from ..models import decode_step, init_decode_cache, init_params
from ..serving import ContinuousBatcher


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
    batcher = ContinuousBatcher(
        lambda p, c, t: decode_step(cfg, p, c, t), None, slots)
    batcher.submit(requests)
    stats = batcher.run(params, cache, tokens, max_steps=max_steps)
    return stats, stats["wall"] / max(stats["tokens"], 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="zamba2-7b")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    args = ap.parse_args(argv)

    cfg = smoke_reduce(get_config(args.arch)) if args.smoke \
        else get_config(args.arch)
    params = init_params(cfg, 0)
    stats, per_tok = live(cfg, params, slots=args.slots)
    print(f"live: {stats['tokens_per_s']:.0f} tok/s on {args.slots} slots "
          f"({cfg.family}); per-token {per_tok * 1e6:.0f} us")


if __name__ == "__main__":
    main()
