"""msgpack <-> numpy codec, wire-compatible with the ``msgpack_numpy``
package the reference depends on (data/data.py:21-23) but not installed
here. Arrays are encoded as maps with keys b'nd', b'type', b'kind',
b'shape', b'data' — the exact layout msgpack_numpy emits, so records
written by the reference's prepro pipeline decode unchanged.
"""

from __future__ import annotations

import numpy as np
import msgpack


def encode(obj):
    if isinstance(obj, np.ndarray):
        kind = b""
        if obj.dtype.kind == "V":  # structured
            kind = b"V"
            typ = obj.dtype.descr
        else:
            typ = obj.dtype.str
        return {
            b"nd": True,
            b"type": typ,
            b"kind": kind,
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, (np.bool_, np.number)):
        return {b"nd": False, b"type": obj.dtype.str, b"data": obj.tobytes()}
    if isinstance(obj, complex):
        return {b"complex": True, b"data": repr(obj)}
    return obj


def decode(obj):
    if not isinstance(obj, dict):
        return obj
    if obj.get(b"nd") is True:
        typ = obj[b"type"]
        if obj.get(b"kind") == b"V":
            typ = [tuple(str(t) for t in d) for d in typ]
        return np.frombuffer(
            obj[b"data"], dtype=np.dtype(typ)
        ).reshape(obj[b"shape"])
    if obj.get(b"nd") is False:
        return np.frombuffer(obj[b"data"], dtype=np.dtype(obj[b"type"]))[0]
    if obj.get(b"complex") is True:
        return complex(obj[b"data"])
    return obj


def packb(obj) -> bytes:
    return msgpack.packb(obj, default=encode, use_bin_type=True)


def unpackb(buf: bytes, **kw):
    kw.setdefault("raw", False)
    kw.setdefault("strict_map_key", False)
    return msgpack.unpackb(buf, object_hook=decode, **kw)
