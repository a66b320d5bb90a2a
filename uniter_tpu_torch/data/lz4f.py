"""LZ4 frame compress/decompress via ctypes on the system liblz4.

The reference txt_db records are ``lz4.frame.compress(msgpack)`` blobs
(data/data.py:19,161-169); the python ``lz4`` package is not available here,
but the native library is — this binding is wire-compatible with
lz4.frame so released txt DBs decode unchanged.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

_lib = None
_TLS = threading.local()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            _lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _lib is None:
        raise RuntimeError("liblz4 not found")
    _lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    _lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    _lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    _lib.LZ4F_compressFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    _lib.LZ4F_isError.restype = ctypes.c_uint
    _lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
    _lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    _lib.LZ4F_createDecompressionContext.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
    ]
    _lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
    _lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
    _lib.LZ4F_decompress.restype = ctypes.c_size_t
    _lib.LZ4F_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p,
    ]
    return _lib


LZ4F_VERSION = 100


def compress(data: bytes) -> bytes:
    lib = _load()
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    out = ctypes.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(out, bound, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError(f"LZ4F_compressFrame error {n}")
    return out.raw[:n]


def _ctx():
    """Thread-local decompression context, created once per thread: context
    alloc/free per record measurably dominated small-record decode. A
    cleanly-finished frame (rc == 0) leaves the context ready for the next;
    error paths drop the cached context so a dirty one is never reused."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        lib = _load()
        ctx = ctypes.c_void_p()
        err = lib.LZ4F_createDecompressionContext(
            ctypes.byref(ctx), LZ4F_VERSION)
        if lib.LZ4F_isError(err):
            raise RuntimeError("LZ4F context creation failed")
        _TLS.ctx = ctx
    return ctx


def decompress(data) -> bytes:
    """Decompress one LZ4 frame. ``data`` may be bytes or any buffer
    (memoryview into an lmdbx mmap): the source is passed to the C call
    zero-copy via a numpy view, and the output is copied out exactly once
    (``create_string_buffer(data, ...)`` input copies and the full-capacity
    ``.raw`` output copy were both pure overhead)."""
    lib = _load()
    ctx = _ctx()
    src_arr = np.frombuffer(data, dtype=np.uint8)  # zero-copy, keeps buf alive
    n_src = src_arr.shape[0]
    src_base = src_arr.ctypes.data
    try:
        chunks = []
        src_off = 0
        dst_cap = max(4 * n_src, 1 << 16)
        dst = getattr(_TLS, "dst", None)
        if dst is None or len(dst) < dst_cap:
            dst = _TLS.dst = (ctypes.c_char * dst_cap)()
        while src_off < n_src:
            src_size = ctypes.c_size_t(n_src - src_off)
            dst_size = ctypes.c_size_t(len(dst))
            rc = lib.LZ4F_decompress(
                ctx,
                dst, ctypes.byref(dst_size),
                ctypes.c_void_p(src_base + src_off), ctypes.byref(src_size),
                None,
            )
            if lib.LZ4F_isError(rc):
                raise RuntimeError(f"LZ4F_decompress error {rc}")
            if not chunks and rc == 0 and src_off + src_size.value >= n_src:
                return ctypes.string_at(dst, dst_size.value)  # common case
            chunks.append(ctypes.string_at(dst, dst_size.value))
            src_off += src_size.value
            if rc == 0:
                break
        if src_off < n_src and rc != 0:
            # truncated frame: the context is mid-frame (dirty) — drop it
            raise RuntimeError("LZ4F_decompress: truncated frame")
        return b"".join(chunks)
    except Exception:
        _TLS.ctx = None
        lib.LZ4F_freeDecompressionContext(ctx)
        raise
