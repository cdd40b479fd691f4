"""Lane sharding rules of the campaign mesh.

The lane half of ``repro.distributed.sharding`` (its lines 28-57): a
campaign mesh (``repro_torch.launch.mesh.campaign_mesh``) is an ordered
list of devices along one ``data`` axis, and every batched lane dimension
(instances, what-if candidate rows) is cut into one contiguous shard a
device.  The parameter, optimizer, batch and cache specs of the model
stack wait for the port of the rest of the LLM stack.
"""

from __future__ import annotations

from typing import Sequence, Tuple

#: the axes a campaign batch is split over: a campaign mesh has one
DATA_AXES = ("data",)


def data_axes(mesh: Sequence) -> Tuple[str, ...]:
    """The composed batch axes of a campaign mesh: ``("data",)``."""
    return DATA_AXES


def lane_spec(mesh: Sequence) -> Tuple[str, ...]:
    """Leading-axis lane sharding for campaign batches: instances / what-if
    candidate rows shard over the data axis, everything trailing (schedule
    slots, PEs) stays on the lane's device."""
    return data_axes(mesh)


def lane_count(mesh: Sequence) -> int:
    """Extent of the data axis — the number of lane shards."""
    return len(mesh)


def pad_lanes(n: int, mesh: Sequence) -> int:
    """Round a lane count up to a multiple of the mesh's data extent so the
    leading axis divides evenly.  Padding lanes carry ``count == 0``
    schedules (the event cores never execute them) and are sliced off
    host-side, so the split results equal the unsplit ones bit for bit."""
    d = lane_count(mesh)
    return -(-n // d) * d


def shard_bounds(n: int, mesh: Sequence) -> Tuple[Tuple[int, int], ...]:
    """The ``[lo, hi)`` rows of each device's contiguous shard of ``n``
    lanes, ``n`` a multiple of the mesh's extent (:func:`pad_lanes`)."""
    d = lane_count(mesh)
    if n % d:
        raise ValueError(f"{n} lanes do not split evenly over {d} devices")
    s = n // d
    return tuple((i * s, (i + 1) * s) for i in range(d))
