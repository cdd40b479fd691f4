"""Atomic, asynchronous checkpoints in the reference's on-disk format.

The counterpart of ``repro.checkpoint.manager``, format for format, so a
checkpoint written by either package restores in the other:

* every leaf of the state tree is its own ``.npy`` under a ``step_%09d``
  directory, named by its path with ``/`` turned into ``__``;
* the leaves' paths are the reference's (``jax.tree_util`` key paths): a
  dict key as itself, a named-tuple field as ``.<field>``, a sequence
  index as its number — so the policy trainer's state is
  ``params/w0 ... params/b2``, ``opt/.step``, ``opt/.m/<name>`` and
  ``opt/.v/<name>``;
* ``manifest.json`` maps each path to its file, shape and logical dtype;
  bfloat16 is stored as its ``uint16`` bit pattern and viewed back on
  restore (through torch: the port does not need ``ml_dtypes``);
* writes go to ``<step>.tmp`` and are renamed when whole (the commit), and
  only the newest ``keep`` steps stay;
* ``async_save`` copies the state to the host at once (a consistent
  snapshot) and writes it on a background thread; an error there is raised
  by the next ``wait`` / ``save`` / ``async_save``;
* the leaves are copied to the host and written ``WRITERS`` at a time.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

#: numpy's .npy format has no bfloat16: it is stored as its uint16 bits
_BF16 = "bfloat16"
#: leaves copied to the host and written at a time (a 32 GB state from an
#: H100 to its host's disk: 25.6 s one at a time, 24.5 s four at a time,
#: 21.8 s eight at a time; ``scripts/time_checkpoint.py``)
WRITERS = 8


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, named-tuple fields and sequence items in order."""
    def join(k: str) -> str:
        return f"{prefix}/{k}" if prefix else k

    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], join(str(k)))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, join(str(i)))]
    return [(prefix, tree)]


def _unflatten(like, leaves: dict, prefix: str = ""):
    """A tree shaped as ``like`` whose leaves come from ``leaves`` by path."""
    def join(k: str) -> str:
        return f"{prefix}/{k}" if prefix else k

    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, join(str(k)))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves,
                                       join(f".{f}"))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves, join(str(i)))
                          for i, x in enumerate(like))
    return leaves[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its logical dtype name.  A
    device leaf's ``.cpu()`` is a fresh host buffer already; a host leaf
    is copied, so that the array is a snapshot (``async_save`` writes it
    after the caller has gone on)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr, logical = t.view(torch.int16).numpy().view(np.uint16), _BF16
        else:
            arr = t.numpy()
            logical = str(arr.dtype)
        return (arr.copy() if leaf.device.type == "cpu" else arr), logical
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        # join any in-flight async save first: a failure on the background
        # thread must re-raise here, not vanish (and two writers must never
        # race on the step directories / GC)
        self.wait()
        return self._write(step, _flatten(tree), _to_host)

    def async_save(self, step: int, tree) -> None:
        """The copy to the host happens here (a consistent snapshot); the
        writes, the rename and the GC run on a background thread.  An
        exception raised there is re-raised by the NEXT ``wait()`` /
        ``save()`` / ``async_save()`` call."""
        self.wait()
        host = [(k, _to_host(v)) for k, v in _flatten(tree)]

        def work():
            try:
                self._write(step, host)
            except BaseException as e:   # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, leaves, to_host=None) -> str:
        """Write ``leaves`` ((path, (array, logical dtype)) pairs, or with
        ``to_host`` (path, leaf) pairs that it turns into those) as the
        step's directory, WRITERS leaves at a time."""
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def one(item):
            key, leaf = item
            arr, logical = leaf if to_host is None else to_host(leaf)
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
            return key, {"file": fn, "shape": list(arr.shape),
                         "dtype": logical}

        with concurrent.futures.ThreadPoolExecutor(WRITERS) as pool:
            manifest = dict(pool.map(one, leaves))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "arrays": manifest,
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like,
                device: Union[str, torch.device, None] = None):
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf takes its ``like`` leaf's dtype and lies on ``device`` (default:
        the ``like`` leaf's own device)."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["arrays"]
        leaves = {}
        for key, leaf in _flatten(like):
            entry = manifest.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = np.load(os.path.join(d, entry["file"]))
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {want}")
            if entry["dtype"] == _BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves[key] = t.to(device=leaf.device if device is None
                               else device, dtype=leaf.dtype)
        return _unflatten(like, leaves)
