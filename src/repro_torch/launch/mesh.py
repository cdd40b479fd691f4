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
nothing more.  :func:`device_mesh` makes the ``torch`` ``DeviceMesh`` of
an :class:`AbstractMesh` over the ranks of the default process group,
which the model stack's DTensors are laid out on; :func:`fake_world`
opens a process group of ``n`` ranks in which this process is rank 0 and
no collective moves data (torch's fake backend), so that one process can
stand for one device of a 256- or 512-device layout (the dry run, and
rank 0's share of a step on the card).

Functions, not module constants: importing this module reads no device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from contextlib import contextmanager
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


def device_mesh(mesh: AbstractMesh, device_type: Optional[str] = None):
    """The ``DeviceMesh`` of ``mesh``'s axes, names and sizes in their
    order (``pod, data, model``), over the ranks of the default process
    group, which must hold ``mesh.size`` of them.  ``device_type``:
    ``"cuda"`` by default, which raises without a card; ``"cpu"`` for a
    mesh of CPU ranks (gloo) or of meta tensors in a :func:`fake_world`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        resolve_device(None)                # raises: no CUDA device
        device_type = "cuda"
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a process group: "
                           "init_process_group, or fake_world")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"{mesh} needs {mesh.size} ranks, the process "
                         f"group has {dist.get_world_size()}")
    dm = init_device_mesh(device_type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    # flattened views of the data axes and of the whole mesh: with them
    # DTensor moves a dim split over several axes (FSDP's gather over
    # ``pod, data``, a sum over every axis) in one collective over their
    # product, as XLA does, where it would run one an axis
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if len(data) > 1:
        dm[data]._flatten()
    if dm.ndim > 1:
        dm._flatten()
    return dm


@contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on torch's fake backend, this
    process rank 0, destroyed when the context closes.  Its collectives
    return at once and move nothing: each rank's share of a step runs
    with the shapes and the collectives of the real one, and values that
    arrive by a collective are not the real ones."""
    import torch.distributed as dist
    # torch keeps the fake store in a private module: imported here only
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
