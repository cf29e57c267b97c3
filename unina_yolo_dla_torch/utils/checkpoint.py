"""Reader and writer of the flax msgpack variable files, without flax,
and the reference's step-checkpoint directory (``CheckpointManager``).

flax writes a nested dict whose array leaves are msgpack ext type 1
(``(shape, dtype name, raw C-order bytes)`` packed as msgpack), numpy
scalars as ext type 3 (same payload, 0-d) and complex numbers as ext
type 2. Large arrays may be split into a ``__msgpack_chunked_array__``
dict of chunks. ``save_msgpack`` writes the same bytes flax's
``serialization.to_bytes`` writes for a tree of dicts (keys in their
order, as strings) with numpy leaves.
"""
from __future__ import annotations

import json
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
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"cannot write a {type(x).__name__} leaf")


def _state_dict(tree: Any) -> Any:
    """Dict keys as strings, order kept (flax's state dict of a dict);
    numpy scalars as 0-d arrays, as the reference's ``jax.device_get``
    hands them to flax."""
    if isinstance(tree, dict):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError("dict keys without unique string forms")
        return out
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


def sorted_tree(tree: Any) -> Any:
    """Every dict level with its keys sorted: the order JAX's tree
    utilities give the reference's written variables."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
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


def _restore(template: Any, state: Any, path: str) -> Any:
    """flax's ``from_state_dict`` over dicts: every template key must be
    in the file (extra keys are dropped); leaves are the file's."""
    if not isinstance(template, dict):
        return state
    if not isinstance(state, dict):
        raise ValueError(f"expected a dict at {path or '/'}, the file has "
                         f"a {type(state).__name__}")
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(
            f"The target dict keys and state dict keys do not match, target "
            f"dict contains keys {missing} which are not present in state "
            f"dict at path {path or '/'}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}")
            for k, v in template.items()}


def load_msgpack(path: str | Path, template: Any) -> Any:
    """Restore a tree saved with ``save_msgpack`` into ``template``'s
    structure (nested dicts; its leaves are not read), as flax's
    ``serialization.from_bytes`` does."""
    return _restore(template, load_msgpack_raw(path), "")


class CheckpointManager:
    """Step checkpoints under ``directory`` with last/best selection, the
    reference's layout: ``step_<N>.msgpack`` (``save_msgpack``) and
    ``state.json`` recording {step: fitness} and the best/last pointers.
    ``keep`` checkpoints besides the best and the last survive a save. A
    directory written by the reference loads here and the other way
    round."""

    def __init__(self, directory: str | Path, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._meta_path = self.dir / "state.json"
        self.meta = (json.loads(self._meta_path.read_text())
                     if self._meta_path.exists()
                     else {"steps": {}, "best_step": None, "last_step": None})

    def save(self, step: int, tree: Any, fitness: float | None = None
             ) -> Path:
        path = self.dir / f"step_{step}.msgpack"
        save_msgpack(tree, path)
        self.meta["steps"][str(step)] = fitness
        self.meta["last_step"] = step
        if fitness is not None:
            best = self.meta.get("best_step")
            best_fit = (self.meta["steps"].get(str(best))
                        if best is not None else None)
            if best_fit is None or fitness > best_fit:
                self.meta["best_step"] = step
        self._gc()
        self._meta_path.write_text(json.dumps(self.meta, indent=2))
        return path

    def _gc(self) -> None:
        steps = sorted(int(s) for s in self.meta["steps"])
        protected = {self.meta.get("best_step"), self.meta.get("last_step")}
        removable = [s for s in steps if s not in protected]
        for s in removable[:max(0, len(removable) - self.keep)]:
            (self.dir / f"step_{s}.msgpack").unlink(missing_ok=True)
            del self.meta["steps"][str(s)]

    def _load(self, step: int | None, template: Any) -> Any:
        if step is None:
            raise FileNotFoundError(f"no checkpoint recorded in {self.dir}")
        return load_msgpack(self.dir / f"step_{step}.msgpack", template)

    def load_last(self, template: Any) -> Any:
        return self._load(self.meta.get("last_step"), template)

    def load_best(self, template: Any) -> Any:
        return self._load(self.meta.get("best_step")
                          or self.meta.get("last_step"), template)
