"""ctypes binding for the native lmdbx engine (native/lmdbx/lmdbx.cc).

Builds the shared library on demand with g++ if it is missing (no
pip/pybind11 dependency), from the repo's ``native/lmdbx/lmdbx.cc`` into
``build/uniter_tpu_torch/`` so it never races the JAX package's own build.
``LmdbStore`` implements the KVStore interface over released LMDB
``data.mdb`` files; ``write_lmdb`` bulk-creates one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Iterator, Optional

from uniter_tpu_torch.data.store import KVStore

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "lmdbx", "lmdbx.cc")
_SO = os.path.join(_REPO, "build", "uniter_tpu_torch", "liblmdbx.so")

_lib = None
_lock = threading.Lock()

# CPython C API: wrap a raw (pointer, size) as a read-only memoryview with
# no copy and no per-size ctypes array-type churn.
_PyBUF_READ = 0x100
_PyMemoryView_FromMemory = ctypes.pythonapi.PyMemoryView_FromMemory
_PyMemoryView_FromMemory.restype = ctypes.py_object
_PyMemoryView_FromMemory.argtypes = [
    ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int]


def _mv_from_memory(ptr, n):
    return _PyMemoryView_FromMemory(ptr, n, _PyBUF_READ)


def _build():
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}"
    subprocess.check_call(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC])
    os.replace(tmp, _SO)


def load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.lmdbx_open.restype = ctypes.c_void_p
        lib.lmdbx_open.argtypes = [ctypes.c_char_p]
        lib.lmdbx_close.argtypes = [ctypes.c_void_p]
        lib.lmdbx_entries.restype = ctypes.c_uint64
        lib.lmdbx_entries.argtypes = [ctypes.c_void_p]
        lib.lmdbx_get.restype = ctypes.c_int
        lib.lmdbx_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.lmdbx_cursor_open.restype = ctypes.c_void_p
        lib.lmdbx_cursor_open.argtypes = [ctypes.c_void_p]
        lib.lmdbx_cursor_next.restype = ctypes.c_int
        lib.lmdbx_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.lmdbx_cursor_close.argtypes = [ctypes.c_void_p]
        lib.lmdbx_builder_new.restype = ctypes.c_void_p
        lib.lmdbx_builder_new.argtypes = [ctypes.c_char_p]
        lib.lmdbx_builder_add.restype = ctypes.c_int
        lib.lmdbx_builder_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lmdbx_builder_finish.restype = ctypes.c_int
        lib.lmdbx_builder_finish.argtypes = [ctypes.c_void_p]
        lib.lmdbx_builder_abort.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class LmdbStore(KVStore):
    def __init__(self, path: str):
        self.lib = load_lib()
        self.handle = self.lib.lmdbx_open(path.encode())
        if not self.handle:
            raise IOError(f"cannot open LMDB at {path}")
        self.path = path

    def get(self, key: str) -> Optional[bytes]:
        val = ctypes.POINTER(ctypes.c_ubyte)()
        vlen = ctypes.c_size_t()
        k = key.encode()
        rc = self.lib.lmdbx_get(
            self.handle, k, len(k), ctypes.byref(val), ctypes.byref(vlen))
        if rc != 0:
            return None
        return ctypes.string_at(val, vlen.value)

    def get_view(self, key: str):
        """Zero-copy read: a read-only memoryview straight into the engine's
        mmap (lmdbx.cc: values point into the map, valid until close). Skips
        the ``string_at`` value copy ``get`` pays — decoders copy payloads
        themselves during unpack, so the hot path never needs owned bytes."""
        val = ctypes.POINTER(ctypes.c_ubyte)()
        vlen = ctypes.c_size_t()
        k = key.encode()
        rc = self.lib.lmdbx_get(
            self.handle, k, len(k), ctypes.byref(val), ctypes.byref(vlen))
        if rc != 0:
            return None
        return _mv_from_memory(
            ctypes.cast(val, ctypes.c_void_p), vlen.value)

    def put(self, key: str, value: bytes) -> None:
        raise IOError("LmdbStore is read-only; use write_lmdb for creation")

    def keys(self) -> Iterator[str]:
        cur = self.lib.lmdbx_cursor_open(self.handle)
        try:
            key = ctypes.POINTER(ctypes.c_ubyte)()
            klen = ctypes.c_size_t()
            while self.lib.lmdbx_cursor_next(
                    cur, ctypes.byref(key), ctypes.byref(klen)):
                yield ctypes.string_at(key, klen.value).decode()
        finally:
            self.lib.lmdbx_cursor_close(cur)

    def __len__(self):
        return int(self.lib.lmdbx_entries(self.handle))

    def close(self):
        if self.handle:
            self.lib.lmdbx_close(self.handle)
            self.handle = None


class LmdbWriter:
    """STREAMING data.mdb creation: keys must arrive in strictly
    increasing order; leaf/overflow pages flush to disk as they fill, so
    building a full-split image DB (tens of GB) needs only ~one leaf of
    resident memory. Use as a context manager; ``abort()`` (or an
    exception) discards the partial file."""

    def __init__(self, db_dir: str):
        self.lib = load_lib()
        os.makedirs(db_dir, exist_ok=True)
        self.path = os.path.join(db_dir, "data.mdb")
        self.handle = self.lib.lmdbx_builder_new(self.path.encode())
        if not self.handle:
            raise IOError(f"cannot create {self.path}")
        self._last = None

    def put(self, key: str, value: bytes):
        k = key.encode()
        if self.lib.lmdbx_builder_add(
                self.handle, k, len(k), value, len(value)) != 0:
            self.abort()
            if self._last is not None and key <= self._last:
                raise ValueError(
                    f"lmdbx: keys must arrive sorted ({key!r} after "
                    f"{self._last!r}) — sort the input file list")
            raise ValueError(
                f"lmdbx: key {key!r} exceeds LMDB's 511-byte maxkeysize "
                "(or an earlier I/O error)")
        self._last = key

    def finish(self):
        h, self.handle = self.handle, None
        if h and self.lib.lmdbx_builder_finish(h) != 0:
            raise IOError(f"lmdbx write failed for {self.path}")

    def abort(self):
        h, self.handle = self.handle, None
        if h:
            self.lib.lmdbx_builder_abort(h)
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            self.abort()
        elif self.handle:
            self.finish()
        return False

    def __del__(self):
        if getattr(self, "handle", None):
            self.abort()


def write_lmdb(db_dir: str, records: Dict[str, bytes]):
    """Bulk-create ``db_dir/data.mdb`` from a dict (sorted here)."""
    with LmdbWriter(db_dir) as w:
        for key in sorted(records):
            w.put(key, records[key])
