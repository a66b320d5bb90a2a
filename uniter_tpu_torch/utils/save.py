"""Weights-only snapshots written by the JAX package
(``ckpt/model_step_N.msgpack``, flax ``serialization.to_bytes``), read
with ``msgpack`` and numpy alone.

flax's format: a msgpack map of nested string-keyed maps whose leaves are
ext type 1 (ndarray: a msgpack tuple of shape, dtype name and C-order
bytes) or ext type 3 (numpy scalar, same payload). Arrays above 2**30
bytes are split into ``__msgpack_chunked_array__`` maps.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        raise TypeError("bfloat16 arrays in a snapshot are not supported; "
                        "the JAX package exports fp32 weights")
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_hook(code, data):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"not a weights snapshot: msgpack ext type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_params_msgpack(path: str) -> Dict[str, Any]:
    """The parameter tree of a flax msgpack snapshot, as nested dicts of
    numpy arrays (the input of ``models.checkpoint.state_dict_from_jax_params``)."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)
