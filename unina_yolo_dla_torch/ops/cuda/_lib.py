"""Build and load the port's CUDA kernels (one shared library, ctypes).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface under ``build/torch_kernels/`` at the
repository root, named by a hash of the sources so a stale build is never
loaded. The build happens at the first launch, never at import.

Each exported C function launches its kernel(s) on the stream it is given
and returns ``cudaGetLastError()``; ``Kernel.launch`` raises on non-zero.
All sources compile with ``--fmad=false``: kernels that must agree bit for
bit with their plain PyTorch versions get no silent multiply-add
contraction.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
KERNELS: list["Kernel"] = []   # every entry point made, in order


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the kernels (if this source set has no library yet)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libunina_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(out)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(lib_path)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


class Kernel:
    """One exported C entry point and its launch count.

    ``launches`` is a plain int: ``launch`` adds one each time it launches
    the kernel, and nothing else touches it except a caller resetting it.
    Every instance is listed in ``KERNELS``.
    """

    def __init__(self, symbol: str, argtypes: list) -> None:
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def query(symbol: str, argtypes: list, *args) -> int:
    """Call an exported C function that launches nothing (a question to
    the library, such as a launch's shape); no kernel's count moves."""
    fn = getattr(library(), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn(*args)


def last_launch(symbol: str) -> dict:
    """The shape of the last launch a source file made, as its C function
    ``symbol`` records it: grid, cluster, threads a block, dynamic shared
    memory."""
    out = (ctypes.c_int * 5)()
    query(symbol, [ctypes.POINTER(ctypes.c_int)], out)
    gx, gy, cl, threads, smem = out
    return dict(grid=[gx, gy, 1], cluster=[cl, 1, 1], threads=threads,
                smem_bytes=smem)


def stream_ptr(device) -> int:
    """The handle of ``device``'s current CUDA stream (the capture stream
    inside a graph capture). The raw accessor skips building a
    ``torch.cuda.Stream`` object, a few microseconds of every launch."""
    import torch

    if not isinstance(device, torch.device):
        device = torch.device(device)
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check_cuda(t, name: str, dtype, shape=None) -> None:
    """Device, dtype, shape and contiguity checks of a kernel operand."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
