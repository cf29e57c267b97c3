"""Reader and writer of the flax msgpack variable files, without flax.

flax writes a nested dict whose array leaves are msgpack ext type 1
(``(shape, dtype name, raw C-order bytes)`` packed as msgpack), numpy
scalars as ext type 3 (same payload, 0-d) and complex numbers as ext
type 2. Large arrays may be split into a ``__msgpack_chunked_array__``
dict of chunks. ``save_msgpack`` writes the same bytes flax's
``serialization.to_bytes`` writes for a tree of dicts (keys in their
order, as strings) with numpy leaves.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # no numpy bfloat16 here: widen exactly to float32 (bf16 is the
        # top half of an f32)
        raw = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (raw << 16).view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _dict_to_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk_in_place(d: Any) -> Any:
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            flat = np.concatenate(_dict_to_tuple(d["chunks"]))
            return flat.reshape(_dict_to_tuple(d["shape"]))
        for k, v in d.items():
            d[k] = _unchunk_in_place(v)
    return d


# flax splits arrays above this many bytes into chunks; no leaf of this
# model comes near it, so the writer refuses them instead
_MAX_LEAF_BYTES = 2 ** 30


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_default(x):
    if isinstance(x, np.ndarray):
        if x.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"a {x.nbytes}-byte leaf would need flax's "
                             "chunked form, which this writer lacks")
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"cannot write a {type(x).__name__} leaf")


def _state_dict(tree: Any) -> Any:
    """Dict keys as strings, order kept (flax's state dict of a dict)."""
    if isinstance(tree, dict):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError("dict keys without unique string forms")
        return out
    return tree


def save_msgpack(tree: dict[str, Any], path: str | Path) -> None:
    """Write ``tree`` (nested dicts with numpy leaves) as flax's
    ``save_msgpack`` would (the inverse of ``load_msgpack_raw``), creating
    the parent directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.packb(_state_dict(tree), default=_ext_default,
                                   strict_types=True))


def load_msgpack_raw(path: str | Path) -> dict[str, Any]:
    """Template-free restore: plain nested dict of numpy arrays."""
    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                           raw=False)
    return _unchunk_in_place(tree)
