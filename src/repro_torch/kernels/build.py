"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use each is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
checkout's ``build/`` directory (git ignores it), named by a hash of the
source and the flags so that an edited source is rebuilt, and loaded with
``ctypes``.  Nothing is built when the module is imported, and nothing falls
back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: the checkout's build directory (src/repro_torch/kernels -> repo root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: ctypes signatures of the C entry points, by source
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "event_loop.cu": {
        "event_finish_launch": (_P,) * 7 + (_P, _I, _I, _I, _P),
        "event_finish_fused_launch": (_P,) * 13 + (_P, _I, _I, _I, _I, _P),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the path, or
    the toolkit's default location."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


def build(source: str) -> float:
    """Compile one source unless its library is built already; returns the
    seconds it took (0 if it was built).  The library is written under a
    temporary name and renamed, so a cut build never leaves a half-written
    library behind.  Raises if nvcc fails."""
    out = library_path(source)
    if out.exists():
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / source)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            build(source)
            lib = ctypes.CDLL(str(library_path(source)))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LOADED[source] = lib
        return lib
