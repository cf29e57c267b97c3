"""ctypes binding of the native host's C ABI (``src/host_capi.cpp``,
``libunina_host.so``): the C++ staging and compaction, and both executors,
called from a Python process so that their bytes can be held against the
Python entry points on real frames. Records come back as the executor
blob of ``runtime/embed.py`` (u32 count, then 24-byte records)."""
from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import build

RECORD_BYTES = 24
LAYOUTS = {"rgb": 0, "blocked": 1, "merged": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "unina_last_error": ([], ctypes.c_char_p),
    "unina_stage": ([_I, _I, _P, _I, _I, _I, _P], _I),
    "unina_compact": ([_P, _I, _P], _I),
    "unina_executor_create": ([ctypes.c_char_p, ctypes.c_char_p, _I, _I,
                               ctypes.POINTER(_P)], _I),
    "unina_executor_depth": ([_P], _I),
    "unina_executor_submit": ([_P, _P, _I, _I, _I], _I),
    "unina_executor_collect": ([_P, _P, _I, ctypes.POINTER(_I)], _I),
    "unina_executor_infer": ([_P, _P, _I, _I, _I, _P, _I,
                              ctypes.POINTER(_I)], _I),
    "unina_executor_destroy": ([_P], None),
}
SENTINEL = struct.pack("<I", 0xFFFFFFFF)

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The C ABI, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.capi_library()))
        for name, (args, res) in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
    return _lib


def _raise(what: str) -> None:
    raise RuntimeError(f"{what}: {library().unina_last_error().decode()}")


def _frame_ptr(frame: np.ndarray) -> int:
    if frame.dtype != np.uint8 or not frame.flags.c_contiguous:
        raise ValueError("frames are contiguous uint8 arrays")
    return frame.ctypes.data


def stage(layout: str, frame: np.ndarray, width: int, height: int,
          channels: int) -> np.ndarray | None:
    """The C++ staging of a square ring frame (channels 3 RGB, 4 BGRA, 0
    NV12) into ``layout`` (``rgb``, ``blocked`` or ``merged``) -> flat
    uint8 bytes, or None for a refused geometry."""
    frame = np.ascontiguousarray(frame)
    out = np.empty(width * width * 3, np.uint8)
    err = library().unina_stage(LAYOUTS[layout], width, _frame_ptr(frame),
                                width, height, channels, out.ctypes.data)
    return None if err else out


def compact(packed: np.ndarray) -> bytes:
    """The C++ compaction of (K, 7) float32 packed rows -> the executor
    blob."""
    packed = np.ascontiguousarray(packed, np.float32)
    out = np.empty(len(packed) * RECORD_BYTES + 1, np.uint8)
    n = library().unina_compact(packed.ctypes.data, len(packed),
                                out.ctypes.data)
    return struct.pack("<I", n) + out[:n * RECORD_BYTES].tobytes()


class Executor:
    """A native executor (``kind`` ``"python"`` or ``"cuda"``) on an
    artifact; ``close()`` (or the context) releases it."""

    def __init__(self, kind: str, artifact: str, input_size: int = 640,
                 num_classes: int = 4, capacity: int = 1024) -> None:
        self._lib = library()
        handle = _P()
        if self._lib.unina_executor_create(
                kind.encode(), str(artifact).encode(), input_size,
                num_classes, ctypes.byref(handle)) != 0:
            _raise(f"{kind} executor")
        self._h = handle
        self._out = np.empty(capacity * RECORD_BYTES, np.uint8)
        self._cap = capacity
        self.depth = self._lib.unina_executor_depth(self._h)

    def _blob(self, count: int) -> bytes:
        return struct.pack("<I", count) + \
            self._out[:count * RECORD_BYTES].tobytes()

    def infer(self, frame: np.ndarray, width: int, height: int,
              channels: int) -> bytes:
        """submit + collect -> the blob, or the sentinel."""
        frame = np.ascontiguousarray(frame)
        count = _I(0)
        err = self._lib.unina_executor_infer(
            self._h, _frame_ptr(frame), width, height, channels,
            self._out.ctypes.data, self._cap, ctypes.byref(count))
        if err < 0:
            _raise("infer")
        return SENTINEL if err else self._blob(count.value)

    def submit(self, frame: np.ndarray, width: int, height: int,
               channels: int) -> bool:
        """Enqueue a frame (its bytes are staged before this returns);
        False for a refused geometry."""
        frame = np.ascontiguousarray(frame)
        err = self._lib.unina_executor_submit(self._h, _frame_ptr(frame),
                                              width, height, channels)
        if err < 0:
            _raise("submit")
        return err == 0

    def collect(self) -> bytes:
        """The oldest submitted frame's blob."""
        count = _I(0)
        if self._lib.unina_executor_collect(
                self._h, self._out.ctypes.data, self._cap,
                ctypes.byref(count)) != 0:
            _raise("collect")
        return self._blob(count.value)

    def close(self) -> None:
        if self._h:
            self._lib.unina_executor_destroy(self._h)
            self._h = None

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
