"""Device policy of the port: entry points run on the card.

``resolve_device(None)`` is ``cuda``; with no card it raises.  The CPU is
used only when a caller asks for it by name (``device="cpu"``), as the tests
do.  Nothing in the port moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

#: compute capability the hand-written kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda``.

    Raises ``RuntimeError`` when the device is CUDA and no card is present,
    and when the card is not a Hopper part (the kernels are built for
    ``sm_90a`` only)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on an NVIDIA H100 "
            "(pass device='cpu' explicitly to use the plain CPU path)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the event-loop kernels need {KERNEL_CAPABILITY} (sm_90a)")
    return dev
