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
import struct
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
    # q k v bias out out_lo lse lse_lo, B S H D, q/k/v strides, sm_scale,
    # dropout threshold, 1/(1-rate), seed, row base, total heads, first
    # head, dtype, stream
    "mha_fwd": [_P] * 8 + [_I] * 4 + [_L] * 9 + [_F, _U, _F, _UL, _UL, _I,
                                                 _I, _I, _P],
    # q k v g bias out out_lo lse lse_lo dq dk dv scratch, B S H D, q/k/v/g
    # strides, then as mha_fwd with the key-tile groups before the stream
    "mha_bwd": [_P] * 13 + [_I] * 4 + [_L] * 12 + [_F, _U, _F, _UL, _UL, _I,
                                                   _I, _I, _I, _P],
    # the fused tails: one packed argument block (TAIL_CALL)
    **{k: [ctypes.c_char_p] for k in ("drop_res_ln_fwd", "drop_res_ln_bwd",
                                      "ln_drop_fwd", "ln_drop_bwd")},
    # the multiway tails: their own packed block (MULTI_CALL)
    "multiway_tail_fwd": [ctypes.c_char_p],
    # the backward tails' grid: rows, H, dtype, K4 (1) or K6 (0), device
    "tail_bwd_grid": [_L, _I, _I, _I, _I],
    # K7: its own packed block (IPOT_CALL); K8: the tails' (TAIL_CALL); K9:
    # its own (ops/ffn.py _CALL)
    "ipot": [ctypes.c_char_p], "layer_norm_fwd": [ctypes.c_char_p],
    "ffn_fwd": [ctypes.c_char_p],
    # K9's dynamic shared memory at D_in, D_out, dtype (for the record)
    "ffn_smem_bytes": [_I, _I, _I],
}
# kernel name -> the csrc/<source>.cu that defines it
SOURCES = {"mha_fwd": "mha_fwd", "mha_bwd": "mha_bwd", "ipot": "ipot",
           "ffn_fwd": "ffn", "ffn_smem_bytes": "ffn",
           **{k: "fused_tail" for k in ("drop_res_ln_fwd", "drop_res_ln_bwd",
                                        "ln_drop_fwd", "ln_drop_bwd",
                                        "tail_bwd_grid", "layer_norm_fwd",
                                        "multiway_tail_fwd")}}

# source -> what it links beyond the CUDA runtime: K9 encodes its TMA tensor
# maps with libcuda's cuTensorMapEncodeTiled
LINK = {"ffn": ["-lcuda"]}
# csrc/fused_tail.cu `TailCall`, the one argument of the tail entries and of
# K8: 8 pointers (x, res, w, b or g, y or dx, dres, part, dwdb; 0 where a
# kernel has none), rows, H, the dropout threshold, 1 / (1 - rate), the
# blocks of part, seed, eps, dtype, device, stream, the dropout row base
TAIL_CALL = struct.Struct("<8Qqi I f i Q f i i 4x Q q")
# csrc/fused_tail.cu `MultiwayCall`: a TAIL_CALL, then the second weight set
# (w2, b2), the sum's buffer (or 0) and the row segments (seg, split)
MULTI_CALL = struct.Struct(TAIL_CALL.format + "3Q q q")
# csrc/ipot.cu `IpotCall`, K7's one argument: 8 pointers (the cost C, x_len,
# y_len, x_pad, y_pad, joint_pad, the plan T, the workspace or 0), B, N, M,
# iteration, k, form, beta, device, stream
IPOT_CALL = struct.Struct("<8Q6i f i Q")

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}  # kernel name -> its typed entry point
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
        if name in LINK:  # the toolkit's link stubs stand in for libcuda
            root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
            cmd += [f"-L{os.path.join(root, d, 'stubs')}"
                    for d in ("lib64", "targets/x86_64-linux/lib")
                    if os.path.isdir(os.path.join(root, d, "stubs"))]
            cmd += LINK[name]
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


def entry(name: str):
    """The C entry point ``uniter_<name>``, resolved once (its first use
    builds the kernels): the wrappers' launch path looks it up in a dict."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load(name), f"uniter_{name}")
    return fn
