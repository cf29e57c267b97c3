"""Build the native perception host with ``g++`` (no cmake).

Three targets from ``include/`` and ``src/`` here, compiled by three
``g++ -std=c++17 -O2`` processes started together, into
``build/torch_native/<hash>/`` at the repository root, named by a hash of
the sources, the flags and the interpreter, so a stale build is never run:

- ``perception_host``: the daemon, linked with the shared libpython of the
  interpreter that builds it (``sysconfig``: ``INCLUDEPY``, ``LIBDIR``,
  ``LDLIBRARY``, an rpath to ``LIBDIR``) and told that interpreter's
  executable, so that the embedded interpreter finds the same packages;
- ``ring_tool``: the frame-ring producer and inspector;
- ``libunina_host.so``: the C ABI (``src/host_capi.cpp``,
  ``runtime/native/capi.py``), which takes Python's symbols from the
  Python process that loads it.

The CUDA executor loads ``libcuda.so.1`` at run time, so the host builds
where there is no CUDA. The build happens at first use, never at import.

    python -m unina_yolo_dla_torch.runtime.native.build   # prints the dir
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
BUILD_ROOT = REPO / "build" / "torch_native"
CXXFLAGS = ("-std=c++17", "-O2", "-Wall", "-ffp-contract=off")
# the staging and executors, in the binary and in the C ABI
CORE = ("src/host_staging.cpp", "src/executor_py.cpp",
        "src/executor_cuda.cpp")
HOST = "perception_host"
RING_TOOL = "ring_tool"
CAPI = "libunina_host.so"

_lock = threading.Lock()


def _python() -> dict:
    """The interpreter's embedding flags; raises without a shared
    libpython."""
    cfg = {k: sysconfig.get_config_var(k)
           for k in ("INCLUDEPY", "LIBDIR", "LDLIBRARY")}
    lib = Path(cfg["LIBDIR"] or "") / (cfg["LDLIBRARY"] or "")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED") or \
            not lib.name.endswith(".so") or not lib.exists():
        raise RuntimeError(
            f"no shared libpython for {sys.executable} ({lib}): the "
            "native host embeds the interpreter and cannot be built")
    cfg["LIB"] = lib.name.removeprefix("lib").removesuffix(".so")
    cfg["EXE"] = sys.executable
    return cfg


def _commands(py: dict, out: Path) -> dict[str, list[str]]:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host cannot "
                           "be built")
    inc = ["-I", str(HERE / "include")]
    core = [str(HERE / s) for s in CORE]
    embed = ["-I", py["INCLUDEPY"],
             f'-DUNINA_PYTHON_EXE="{py["EXE"]}"']
    return {
        HOST: [gxx, *CXXFLAGS, *inc, *embed,
               str(HERE / "src" / "perception_host.cpp"), *core,
               "-o", str(out / HOST), "-L", py["LIBDIR"], f"-l{py['LIB']}",
               f"-Wl,-rpath,{py['LIBDIR']}", "-ldl", "-lpthread"],
        RING_TOOL: [gxx, *CXXFLAGS, *inc,
                    str(HERE / "src" / "ring_tool.cpp"),
                    "-o", str(out / RING_TOOL)],
        CAPI: [gxx, *CXXFLAGS, "-fPIC", "-shared", *inc, *embed,
               str(HERE / "src" / "host_capi.cpp"), *core,
               "-o", str(out / CAPI), "-ldl", "-lpthread"],
    }


def build() -> Path:
    """The build directory of this source set, compiled if it has none."""
    with _lock:
        py = _python()
        digest = hashlib.sha256()
        for src in sorted((HERE / "include").glob("*")) + sorted(
                (HERE / "src").glob("*")):
            digest.update(src.name.encode() + src.read_bytes())
        digest.update(repr((CXXFLAGS, py)).encode())
        out = BUILD_ROOT / digest.hexdigest()[:16]
        if out.exists():
            return out
        tmp = BUILD_ROOT / f"{out.name}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                 for name, cmd in _commands(py, tmp).items()}
        failed = []
        for name, p in procs.items():
            log, _ = p.communicate()
            (tmp / f"{name}.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError("g++ failed\n" + "\n".join(failed))
        try:
            tmp.rename(out)
        except OSError:   # another process finished the same build first
            shutil.rmtree(tmp, ignore_errors=True)
        return out


def host_binary() -> Path:
    return build() / HOST


def capi_library() -> Path:
    return build() / CAPI


def host_env() -> dict:
    """The host's environment: this one, with the repository first on
    ``PYTHONPATH`` so that the embedded interpreter imports the port from
    this checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


if __name__ == "__main__":
    print(build())
