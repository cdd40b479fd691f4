"""Carry the reference's state across to the port.

The simulator has no weights: its state is the loops' cost profiles (the
prefix grids and their constants) and the machine constants.  These helpers
take that state out of any object with the reference's fields as plain
numpy arrays and dicts (``*_state``), and build the port's objects from
such dicts (``*_from_state``), so a test can hand the exact reference state
to both engines.  The models' weights cross as a nested dict of numpy
arrays (:func:`model_params_from_jax`), the model's AdamW state as the
reference's nested ``AdamWState`` of numpy arrays
(:func:`model_opt_state_from_jax`), and the policy trainer's weights and
optimizer state as numpy too (:func:`policy_trainer_state_from_jax`).
Nothing here imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .optim.adamw import AdamWState
from .sim.systems import SystemModel
from .sim.workloads import LoopProfile

_PROFILE_FIELDS = ("name", "N", "memory_bound", "locality_sens", "c_loc",
                   "unit")


def profile_state(profile: Any) -> Dict[str, Any]:
    """A loop profile's fields, the prefix grid as a float64 numpy copy
    (``None`` for a uniform loop)."""
    state = {f: getattr(profile, f) for f in _PROFILE_FIELDS}
    grid = profile.prefix_grid
    state["prefix_grid"] = None if grid is None else np.array(grid, np.float64)
    return state


def profile_from_state(state: Dict[str, Any]) -> LoopProfile:
    grid = state["prefix_grid"]
    return LoopProfile(**{f: state[f] for f in _PROFILE_FIELDS},
                       prefix_grid=None if grid is None
                       else np.array(grid, np.float64))


def system_state(system: Any) -> Dict[str, Any]:
    """A machine model's constants as a plain dict."""
    return {f.name: getattr(system, f.name)
            for f in dataclasses.fields(SystemModel)}


def system_from_state(state: Dict[str, Any]) -> SystemModel:
    return SystemModel(**state)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (numpy
    has no such type of its own: ml_dtypes supplies it) cross bit for bit
    through their 16-bit pattern."""
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def model_params_from_jax(tree: Dict[str, Any], device=None
                          ) -> Dict[str, Any]:
    """The port's model parameters from the reference's ``init_params``
    pytree given as numpy arrays (nested dicts, the same keys), dtype for
    dtype, on ``device`` (default the card)."""
    dev = resolve_device(device)
    return {k: model_params_from_jax(v, dev) if isinstance(v, dict)
            else _tensor(np.asarray(v), dev) for k, v in tree.items()}


def policy_trainer_state_from_jax(params: Dict[str, Any], opt: Any,
                                  device=None):
    """The port's ``(params, AdamWState)`` from the reference policy
    trainer's ``params`` dict and ``AdamWState`` (``step``, ``m``, ``v``)
    given as numpy arrays, dtype for dtype, on ``device`` (default the
    card) — the start both trainers take in a comparison."""
    dev = resolve_device(device)

    def leaves(tree):
        return {k: _tensor(np.asarray(v), dev) for k, v in tree.items()}

    return leaves(params), AdamWState(step=_tensor(np.asarray(opt.step), dev),
                                      m=leaves(opt.m), v=leaves(opt.v))


def model_opt_state_from_jax(opt: Any, device=None) -> AdamWState:
    """The port's AdamW state of the model from the reference's
    ``AdamWState`` (``step``, and ``m``, ``v`` nested as the parameters)
    given as numpy arrays, dtype for dtype, on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    return AdamWState(step=_tensor(np.asarray(opt.step), dev),
                      m=model_params_from_jax(opt.m, dev),
                      v=model_params_from_jax(opt.v, dev))
