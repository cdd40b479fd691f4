"""Fault-tolerant training runtime: what the policy trainer shares with
the model trainer.

The counterpart of ``repro.runtime.trainer``, as far as the port has a
trainer: :class:`SimulatedFailure`, the exception ``failure_rate``
injects at a step boundary, after which a trainer restores its latest
checkpoint and replays.  The model ``Trainer`` waits for the port of the
rest of the LLM stack.
"""

from __future__ import annotations


class SimulatedFailure(RuntimeError):
    pass
