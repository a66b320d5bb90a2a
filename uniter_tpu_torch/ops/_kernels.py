"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/uniter_tpu_torch/lib<name>.so`` at first
use, and ``ctypes`` loads it. No source includes PyTorch's headers, so a
build takes seconds. Sources build in parallel, one ``nvcc`` each; a
library newer than its source is reused.

Nothing here runs at import, so a machine without the CUDA toolkit (the
CPU test suite's) imports every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "uniter_tpu_torch")
ARCH = "arch=compute_90a,code=sm_90a"

# kernel name -> ctypes signature of its C entry point ``uniter_<name>``
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "mha_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so)


def build(names: Iterable[str] = tuple(SIGNATURES), *,
          verbose: bool = False) -> Dict[str, str]:
    """Compile the stale kernels of ``names``, all at once. Returns each
    built kernel's compiler output (``-Xptxas -v`` register and shared
    memory report when ``verbose``); raises with that output on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}"
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, src]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, so)  # a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            fn = getattr(lib, f"uniter_{name}")
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
