"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  At first use each is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
checkout's ``build/`` directory (git ignores it), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags so that an
edited source or header is rebuilt, and loaded with ``ctypes``.  Nothing
is built when the module is imported, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: the checkout's build directory (src/repro_torch/kernels -> repo root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
#: per-source flags: the event loop contracts no multiply-add on its own,
#: so that it rounds as the reference does
EXTRA_FLAGS: Dict[str, Sequence[str]] = {"event_loop.cu": ("-fmad=false",)}

#: ctypes signatures of the C entry points, by source
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "event_loop.cu": {
        "event_finish_launch": (_P,) * 7 + (_P, _I, _I, _I, _P),
        "event_finish_fused_launch": (_P,) * 13 + (_P, _I, _I, _I, _I, _P),
    },
    # x, w, out, rows, D, x dtype, w dtype, eps, then the layout: threads
    # a row, threads a block, blocks, chunks a thread; stream
    # backward: x, w, dy, dx, dw, workspace, rows, D, blocks, x dtype,
    # w dtype, eps, stream
    "rmsnorm.cu": {
        "rmsnorm_launch": (_P, _P, _P, _I, _I, _I, _I, _F) + (_I,) * 4
                          + (_P,),
        "rmsnorm_bwd_launch": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    },
    # q, k, v, out, lse (or null), B, S, T, H, K, hd, dtype, causal, scale,
    # stream
    "flash_attention.cu": {
        "flash_attention_launch": (_P,) * 5 + (_I,) * 8 + (_F, _P),
    },
    # q, k, v, o, dO, lse, dq, dk, dv, delta, B, S, T, H, K, hd, dtype,
    # causal, scale, stream
    "flash_attention_bwd.cu": {
        "flash_attention_bwd_launch": (_P,) * 10 + (_I,) * 8 + (_F, _P),
    },
    # x, dt, A, B, C, y, state, ws, ws floats, b, S, nh, hp, st, chunk,
    # x dtype, stream
    "ssd_scan.cu": {
        "ssd_scan_launch": (_P,) * 8 + (_L,) + (_I,) * 7 + (_P,),
    },
    # x, dt, A, B, C, dy, dstate (or null), dx, ddt, dA, dB, dC, ws, ws
    # floats, b, S, nh, hp, st, chunk, x dtype, stream; the workspace's
    # size: b, S, nh, hp, st, chunk, x dtype, out
    "ssd_scan_bwd.cu": {
        "ssd_scan_bwd_launch": (_P,) * 13 + (_L,) + (_I,) * 7 + (_P,),
        "ssd_scan_bwd_workspace_floats": (_I,) * 7 + (ctypes.POINTER(_L),),
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


def flags(source: str) -> Sequence[str]:
    return NVCC_FLAGS + tuple(EXTRA_FLAGS.get(source, ()))


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where the library of ``source`` is built: named by a hash of the
    source, every shared header of ``csrc`` (in name order) and the flags,
    so that no edit to what the source includes loads a stale library."""
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


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
    proc = subprocess.run([nvcc_path(), *flags(source), "-o", str(tmp),
                           str(CSRC / source)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(sources: Sequence[str] = tuple(SIGNATURES)
              ) -> Dict[str, float]:
    """Compile every source at once, one nvcc process each; returns each
    source's build seconds.  Raises the first failure after all have
    ended."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {s: pool.submit(build, s) for s in sources}
        return {s: f.result() for s, f in futures.items()}


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
