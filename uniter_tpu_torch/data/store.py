"""Record stores: the storage layer under txt_db / img_db.

Backends:
  * ``LmdbStore`` — the reference's on-disk format (data.mdb B+tree),
    served by the native C++ engine in native/lmdbx (ctypes-bound). Reads
    released UNITER DBs unchanged.
  * ``DirStore`` — one file per key under a directory; used for tests and
    for environments without the native build.

``open_store`` sniffs the directory layout (data.mdb -> LMDB).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional


class KVStore:
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def keys(self) -> Iterator[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def get_view(self, key: str):
        """Zero-copy read where the backend supports it (LmdbStore returns
        a read-only memoryview into its mmap, valid until close). Decoders
        consume the view immediately (msgpack copies payloads during
        unpack), so the per-record value copy ``get`` pays is redundant on
        the hot path. Default falls back to ``get``."""
        return self.get(key)

    def view(self, key: str):
        v = self.get_view(key)
        if v is None:
            raise KeyError(key)
        return v

    def __getitem__(self, key: str) -> bytes:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v


class DirStore(KVStore):
    """One file per key. Keys are sanitized with URL-style escaping of '/'."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        if create:
            os.makedirs(path, exist_ok=True)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)

    @staticmethod
    def _fname(key: str) -> str:
        return key.replace("%", "%25").replace("/", "%2F") + ".bin"

    @staticmethod
    def _key(fname: str) -> str:
        return fname[:-4].replace("%2F", "/").replace("%25", "%")

    def get(self, key: str) -> Optional[bytes]:
        p = os.path.join(self.path, self._fname(key))
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def put(self, key: str, value: bytes) -> None:
        with open(os.path.join(self.path, self._fname(key)), "wb") as f:
            f.write(value)

    def keys(self) -> Iterator[str]:
        for fname in sorted(os.listdir(self.path)):
            if fname.endswith(".bin"):
                yield self._key(fname)


def open_store(path: str, create: bool = False) -> KVStore:
    if os.path.exists(os.path.join(path, "data.mdb")):
        from uniter_tpu_torch.data.lmdb_native import LmdbStore

        return LmdbStore(path)
    return DirStore(path, create=create)
