"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`, compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` at first use. The hash covers the source and the flags, so an
edited source builds anew and an unchanged one loads from disk. The
sources have a plain C interface (no PyTorch headers), so a build takes
seconds. Nothing is built when a module is imported: `load()` is called
by the kernel wrappers at their first launch on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")
SOURCES = ("maxvit", "nms")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile(name: str) -> str:
    """Compile one source unless its library exists; returns its path.
    ptxas's report (registers, shared memory, spills of each kernel) is
    kept beside the library as `<lib>.log`."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every source, one nvcc per source, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(_compile, names))


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library `name`, built if needed; `signatures` maps each
    C entry point to its ctypes argument types (each returns int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(fn: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} (cudaError_t); the "
                           "kernel was not launched or failed to launch")
