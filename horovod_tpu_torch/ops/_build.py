"""Build and bind the CUDA kernels of the port.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface, loaded through ``ctypes``: no PyTorch headers,
no ninja, a build of seconds. The library lands in ``ops/_build/`` under a
name that carries the hash of the source, of the ``csrc/*.cuh`` headers it
includes and of the flags, so a build is reused until one of them
changes. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")

NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "--shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# After the source: dlopen/dlsym, with which the wgmma kernels (hopper.cuh)
# find cuTensorMapEncodeTiled in the libcuda.so.1 already loaded (no link
# against it).
NVCC_LIBS = ["-ldl"]

_lock = threading.Lock()  # guards _locks
_locks: dict = {}  # name -> lock of that library's build and load
_libs: dict = {}
# name -> {"seconds": build time or 0.0, "cached": bool, "path": str}
BUILD_INFO: dict = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header of ``csrc/`` that it includes
    (with ``#include "..."``), directly or through another header."""
    paths = [os.path.join(SRC_DIR, name + ".cu")]
    for path in paths:  # grows while it is walked
        with open(path, "rb") as fh:
            for include in _INCLUDE.findall(fh.read()):
                dep = os.path.join(SRC_DIR, include.decode())
                if os.path.exists(dep) and dep not in paths:
                    paths.append(dep)
    return paths


def library_path(name: str) -> str:
    """Path of the built library of ``csrc/<name>.cu`` for the current
    source, the headers it includes and the flags."""
    digest = hashlib.sha256()
    for path in _sources(name):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. The compiler's report (registers, shared
    memory, spills) is kept beside it as ``.log``."""
    out = library_path(name)
    if os.path.exists(out):
        BUILD_INFO[name] = {"seconds": 0.0, "cached": True, "path": out}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(SRC_DIR, name + ".cu"), *NVCC_LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-8000:]}")
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds agree on the result
    BUILD_INFO[name] = {"seconds": seconds, "cached": False, "path": out}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Builds
    of different libraries may run at the same time."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib


def load_all(names) -> dict:
    """Load several libraries, building them in parallel (one ``nvcc`` per
    source, all started together); a failed build raises."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
