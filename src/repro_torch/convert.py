"""Carry the reference's state across to the port.

The simulator has no weights: its state is the loops' cost profiles (the
prefix grids and their constants) and the machine constants.  These helpers
take that state out of any object with the reference's fields as plain
numpy arrays and dicts (``*_state``), and build the port's objects from
such dicts (``*_from_state``), so a test can hand the exact reference state
to both engines.  Nothing here imports the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

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
