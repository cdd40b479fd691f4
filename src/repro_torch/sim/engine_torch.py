"""Single-instance DES on the event-loop kernel: self-scheduled loop
execution as one ``event_finish`` call — the port's counterpart of
``repro.sim.engine_jax`` (``src/repro/sim/engine_jax.py``).

The Python engine (``repro_torch.sim.engine``) is the reference; this
variant runs the same event loop for the *non-adaptive* dynamic algorithms
(SS/GSS/AutoLLVM/TSS/mFAC2) in the form a runtime on the card would embed:
the chunk schedule comes from ``repro_torch.core.sched``, the chunk costs
are interpolated from the prefix grid, and the argmin assignment over the P
thread-available times is the ``event_finish`` kernel with unit speeds, no
boundary cost, no forced PEs and the jitter as start times.  The kernel's
step ``h + cost * 1 + 0`` is the reference's ``h + costs[i]`` exactly.

For whole-campaign batches use ``repro_torch.sim.backends.torch_batched``.
``MAX_EVENTS`` is the shared ``EVENT_CAP`` of the backend protocol.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.sched import chunk_schedule
from ..device import resolve_device
from ..kernels.event_loop import event_finish, prefix_costs
from .backends.base import EVENT_CAP

MAX_EVENTS = EVENT_CAP


def simulate_loop(alg: int, prefix_grid, N: int, P: int, chunk_param: int,
                  max_events: int = MAX_EVENTS, h: float = 1e-7,
                  jitter=None,
                  device: Union[str, torch.device, None] = None):
    """Simulate one loop instance with algorithm ``alg`` (non-adaptive).

    prefix_grid: (G+1,) cumulative cost over [0, N] (float32; a uniform
    loop's grid is a linspace).  ``jitter`` (P,) is each PE's start time
    (zeros when None).  Runs on ``device`` (the card when None).  Returns
    (makespan, finish_times (P,), n_chunks) as float32 tensors and an int.
    """
    dev = resolve_device(device)
    sizes, count = chunk_schedule(alg, N, P, chunk_param,
                                  max_chunks=max_events)
    sizes = sizes[:max(count, 1)]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    grid = torch.as_tensor(prefix_grid, dtype=torch.float32).to(dev)
    G = grid.shape[0] - 1
    K = len(sizes)
    ones = torch.ones((1, K), dtype=torch.float32, device=dev)
    gscale = torch.tensor([np.float32(G) / np.float32(N)], device=dev)
    # the reference's pref(starts + sizes) - pref(starts); loc = noise = 1
    costs = prefix_costs(grid[None], torch.zeros(1, dtype=torch.int32,
                                                 device=dev), gscale,
                         torch.from_numpy(starts[None]).to(dev),
                         torch.from_numpy(sizes[None]).to(dev), ones, ones)
    t0 = (torch.zeros((1, P), dtype=torch.float32, device=dev)
          if jitter is None else
          torch.as_tensor(jitter, dtype=torch.float32).reshape(1, P).to(dev))
    finish = event_finish(
        costs, torch.ones((1, P), dtype=torch.float32, device=dev), t0,
        torch.full((1,), h, dtype=torch.float32, device=dev),
        torch.zeros(1, dtype=torch.float32, device=dev),
        torch.full((1, K), -1, dtype=torch.int32, device=dev),
        torch.tensor([count], dtype=torch.int32, device=dev))[0]
    return finish.max(), finish, int(count)
