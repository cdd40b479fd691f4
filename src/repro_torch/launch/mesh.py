"""Meshes: the devices a campaign's lanes are split over, and the
production layouts that the model stack's sharding specs describe.

The counterpart of ``repro.launch.mesh``.  A JAX mesh is a named array of
devices; here a host mesh is a plain list.  :func:`make_host_mesh` returns
the (data, model) grid as a list of ``data`` rows of ``model`` devices
each, and :func:`campaign_mesh` the ordered list of the data axis's devices
(the model axis is 1: the event cores never split a lane).  By default the
devices are every card (``torch.cuda.device_count()``); with none it
raises, as every entry point of the port does.  A caller may pass its own
``devices`` list instead, for example ``[torch.device("cpu")] * 8``, which
stands in for eight host devices on a machine without cards.

:func:`production_mesh` is ``make_production_mesh``'s layout with no
devices: the (16, 16) ``data, model`` pod or the (2, 16, 16) ``pod, data,
model`` pair of pods as an :class:`AbstractMesh`, the axes' names and
sizes only.  The specs of ``repro_torch.distributed.sharding`` need
nothing more; nothing here places a tensor on a device or creates a
process group.

Functions, not module constants: importing this module reads no device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from types import MappingProxyType
from typing import Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's named axes and their sizes, with no devices (JAX's
    ``AbstractMesh``): ``shape`` maps each axis name to its size, in the
    mesh's order; ``size`` is the number of devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")

    @property
    def shape(self) -> Mapping[str, int]:
        return MappingProxyType(dict(zip(self.axis_names, self.axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self) -> Iterator[Tuple[int, ...]]:
        """Every device's coordinate, one index an axis, row-major."""
        return itertools.product(*(range(n) for n in self.axis_sizes))


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; (2, 16, 16) = 512 chips across two pods
    (``repro.launch.mesh.make_production_mesh``'s layout)."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


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
