"""Host meshes: the devices a campaign's lanes are split over.

The counterpart of ``repro.launch.mesh``.  A JAX mesh is a named array of
devices; here a mesh is a plain list.  :func:`make_host_mesh` returns the
(data, model) grid as a list of ``data`` rows of ``model`` devices each,
and :func:`campaign_mesh` the ordered list of the data axis's devices (the
model axis is 1: the event cores never split a lane).  By default the
devices are every card (``torch.cuda.device_count()``); with none it
raises, as every entry point of the port does.  A caller may pass its own
``devices`` list instead, for example ``[torch.device("cpu")] * 8``, which
stands in for eight host devices on a machine without cards.

Functions, not module constants: importing this module reads no device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import resolve_device


def local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """``devices`` resolved one by one, else every card of the host; raises
    ``RuntimeError`` when there is no card and no list was given."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            resolve_device(None)            # raises: no CUDA device
        devices = [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_host_mesh(model_parallel: int = 1,
                   data_parallel: Optional[int] = None,
                   devices: Optional[Sequence] = None
                   ) -> List[List[torch.device]]:
    """The (data, model) grid over the local devices, as ``data`` rows of
    ``model_parallel`` devices.

    ``data_parallel`` clamps the data axis so callers can request fewer
    lanes than the host exposes; the mesh then covers the first
    ``data_parallel * model_parallel`` devices."""
    devs = local_devices(devices)
    n = len(devs)
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if n % model_parallel != 0:
        raise ValueError(
            f"device count {n} is not divisible by "
            f"model_parallel={model_parallel}; pick a divisor of {n}")
    dp = n // model_parallel
    if data_parallel is not None:
        if data_parallel < 1:
            raise ValueError(
                f"data_parallel must be >= 1, got {data_parallel}")
        dp = min(dp, data_parallel)
    return [devs[i * model_parallel:(i + 1) * model_parallel]
            for i in range(dp)]


def campaign_mesh(data_parallel: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> List[torch.device]:
    """The data axis of a ``model_parallel = 1`` host mesh: the ordered
    devices that ``run_batch`` / ``run_lockstep`` lanes and what-if
    candidate rows are split over, one contiguous shard each."""
    return [row[0] for row in make_host_mesh(1, data_parallel, devices)]
