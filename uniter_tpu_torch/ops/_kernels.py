"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` has a plain C interface: one or more entry points
``uniter_<kernel>`` (``SOURCES`` says which source holds which kernel).
``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/uniter_tpu_torch/lib<source>.so`` at first use, and ``ctypes``
loads it; shared device code lives in ``csrc/*.cuh``
(a newer header rebuilds every kernel). No source includes PyTorch's headers, so a
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
_U, _UL = ctypes.c_uint, ctypes.c_ulonglong
SIGNATURES = {
    # q k v bias out out_lo lse, B S H D, q/k/v strides, sm_scale, dropout
    # threshold, 1/(1-rate), seed, dtype, stream
    "mha_fwd": [_P] * 7 + [_I] * 4 + [_L] * 9 + [_F, _U, _F, _UL, _I, _P],
    # q k v g bias out out_lo lse dq dk dv scratch, B S H D, q/k/v/g
    # strides, then as mha_fwd
    "mha_bwd": [_P] * 12 + [_I] * 4 + [_L] * 12 + [_F, _U, _F, _UL, _I, _P],
    # the fused tails: one packed argument block (ops/fused_block.py _CALL)
    **{k: [ctypes.c_char_p] for k in ("drop_res_ln_fwd", "drop_res_ln_bwd",
                                      "ln_drop_fwd", "ln_drop_bwd")},
    # the backward tails' grid: rows, H, dtype, K4 (1) or K6 (0), device
    "tail_bwd_grid": [_L, _I, _I, _I, _I],
    # x w b y, rows, H, eps, dtype, stream
    "layer_norm_fwd": [_P] * 4 + [_L, _I, _F, _I, _P],
    # A sigma0 x_mask y_mask x_len y_len T, B N M, iteration, k, form, stream
    "ipot": [_P] * 7 + [_I] * 6 + [_P],
    # x w1 b1 w2 b2 y, rows, D_in, D_mid, D_out, dtype, stream
    "ffn_fwd": [_P] * 6 + [_L] + [_I] * 4 + [_P],
}
# kernel name -> the csrc/<source>.cu that defines it
SOURCES = {"mha_fwd": "mha_fwd", "mha_bwd": "mha_bwd", "ipot": "ipot",
           "ffn_fwd": "ffn",
           **{k: "fused_tail" for k in ("drop_res_ln_fwd", "drop_res_ln_bwd",
                                        "ln_drop_fwd", "ln_drop_bwd",
                                        "tail_bwd_grid", "layer_norm_fwd")}}

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
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src, *headers]) > \
        os.path.getmtime(so)


def build(names: Iterable[str] = tuple(sorted(set(SOURCES.values()))), *,
          verbose: bool = False) -> Dict[str, str]:
    """Compile the stale sources of ``names``, all at once. Returns each
    built source's compiler output (``-Xptxas -v`` register and shared
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
    """The library that holds kernel ``name``, its entry point typed. The
    first use of any kernel builds every stale source, all at once (a
    training step needs all of them back to back)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(_paths(SOURCES[name])[1])
            fn = getattr(lib, f"uniter_{name}")
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
