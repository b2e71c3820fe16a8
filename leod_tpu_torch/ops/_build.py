"""Build the op library and register its ops in this process.

`csrc/torch_ops.cpp` defines the custom ops `leod_tpu_torch::*`
(`TORCH_LIBRARY`) and is the one owner of them. It becomes one shared
library, `_build/libleod_ops-<hash>.so`:

- on a machine with `nvcc` and a CUDA build of torch (variant
  "cuda-sm_90a"), `csrc/maxvit.cu` and `csrc/nms.cu` are compiled by
  `nvcc -gencode arch=compute_90a,code=sm_90a` without torch headers,
  `torch_ops.cpp` by `g++` against the running torch's headers with its
  CUDA implementations, all three at once, and `nvcc` links them against
  `c10`, `torch_cpu`, `c10_cuda` and `torch_cuda`;
- where torch is built without CUDA, or there is neither `nvcc` nor a
  card (variant "cpu"), `torch_ops.cpp` alone by `g++`: the schemas,
  the CPU (plain) and Meta implementations and the counters. A card
  without `nvcc` raises.

The hash covers the sources, the flags, `torch.__version__` and the
variant, so an edited source or another torch builds anew and an
unchanged one loads from disk. A build runs under a file lock beside the
library: of the processes that need it at once (test workers, the ranks
of a mesh), one builds and the others wait and load. Nothing is built
when a module is imported: `load()` is called by the kernel wrappers at
their first use (`op`). `counted` gives a wrapper the library's launch
counter and last plan of its op as `.launches` and `.plan`.
"""
from __future__ import annotations

import fcntl
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from .. import artifact

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("maxvit", "nms")            # the kernels, csrc/<name>.cu
OPS_SOURCE = "torch_ops.cpp"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")
GXX_FLAGS = ("-std=c++20", "-O2", "-fPIC")
CUDA_VARIANT, CPU_VARIANT = "cuda-sm_90a", "cpu"

_lock = threading.Lock()
_loaded: Optional[str] = None
# each step's seconds of the last build this process ran
last_build: Dict[str, float] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def variant() -> str:
    """"cuda-sm_90a" where nvcc and a CUDA build of torch are there, else
    "cpu". A machine with a card and without nvcc raises: the library
    there must hold the kernels."""
    if torch.version.cuda is None:
        return CPU_VARIANT
    try:
        nvcc()
    except RuntimeError:
        if torch.cuda.is_available():
            raise
        return CPU_VARIANT
    return CUDA_VARIANT


def _torch_dirs():
    root = os.path.dirname(os.path.abspath(torch.__file__))
    return os.path.join(root, "include"), os.path.join(root, "lib")


def _defines(key: str, var: str) -> List[str]:
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    out = [f"-D_GLIBCXX_USE_CXX11_ABI={abi}", f'-DLEOD_BUILD_ID="{key}"',
           f'-DLEOD_VARIANT="{var}"',
           f'-DLEOD_TORCH_VERSION="{torch.__version__}"']
    return out + (["-DLEOD_WITH_CUDA"] if var == CUDA_VARIANT else [])


def build_key(var: Optional[str] = None) -> str:
    """The hash of the sources, flags, torch version and variant."""
    var = var or variant()
    h = hashlib.sha256()
    for name in (OPS_SOURCE,) + tuple(f"{s}.cu" for s in SOURCES):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + GXX_FLAGS).encode())
    h.update(f"{torch.__version__} {var} "
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}".encode())
    return h.hexdigest()[:16]


def library_path(var: Optional[str] = None) -> str:
    return os.path.join(BUILD_DIR, f"libleod_ops-{build_key(var)}.so")


def _run(cmd: List[str], what: str) -> str:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build[what] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{' '.join(cmd)}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile(out: str, var: str) -> None:
    """Build the library at `out` (the lock held)."""
    inc, lib = _torch_dirs()
    tmp = f"{out}.{os.getpid()}"
    gxx = [shutil.which("g++") or "g++", *GXX_FLAGS, *_defines(
        os.path.basename(out)[len("libleod_ops-"):-len(".so")], var),
        "-I", inc]
    src = os.path.join(CSRC, OPS_SOURCE)
    last_build.clear()
    t0 = time.perf_counter()
    if var == CPU_VARIANT:
        log = _run(gxx + ["-shared", "-o", tmp + ".so", src, "-L", lib,
                          "-lc10", "-ltorch_cpu"], "g++ torch_ops.cpp")
    else:
        cuda_home = os.path.dirname(os.path.dirname(nvcc()))
        jobs = [([nvcc(), *NVCC_FLAGS, "-c", "-o", f"{tmp}.{s}.o",
                  os.path.join(CSRC, f"{s}.cu")], f"nvcc {s}.cu")
                for s in SOURCES]
        jobs.append((gxx + ["-I", os.path.join(cuda_home, "include"), "-c",
                            "-o", f"{tmp}.ops.o", src], "g++ torch_ops.cpp"))
        # one compiler per source, all started together
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            logs = list(pool.map(lambda j: _run(*j), jobs))
        objs = [f"{tmp}.{s}.o" for s in SOURCES] + [f"{tmp}.ops.o"]
        # nvcc links the CUDA runtime statically, as the kernels' own
        # libraries always did
        logs.append(_run([nvcc(), "-shared", "-o", tmp + ".so", *objs,
                          "-L", lib, "-lc10", "-ltorch_cpu", "-lc10_cuda",
                          "-ltorch_cuda"], "link"))
        for o in objs:
            os.remove(o)
        log = "".join(logs)
    last_build["total"] = time.perf_counter() - t0
    with open(f"{out}.log", "w") as f:
        f.write(log + json.dumps({"seconds": last_build}) + "\n")
    os.replace(tmp + ".so", out)


def build(var: Optional[str] = None) -> str:
    """The op library's path, built first unless it is on disk. The
    compiler's report (for the kernels, ptxas's registers, shared memory
    and spills) is kept beside it as `<lib>.log`."""
    var = var or variant()
    out = library_path(var)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                _compile(out, var)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build_all() -> List[str]:
    """Build the op library (its sources compiled together); returns its
    path in a list."""
    return [build()]


def load() -> str:
    """Register the ops in this process and return the library's path.
    Where the process already has them (an artifact's library), they are
    reused if they are this package's build, and raise otherwise: one
    process holds one build of the ops."""
    global _loaded
    if _loaded is not None:
        return _loaded
    with _lock:
        if _loaded is None:
            have = artifact.loaded_ops()
            if have is None:
                path = build()
                torch.ops.load_library(path)
                have = artifact.loaded_ops()
            key = build_key()
            if have["build"] != key:
                raise RuntimeError(
                    f"this process has the ops of build {have['build']} "
                    f"({have['variant']}, torch {have['torch']}, "
                    f"{have['path']}); this package's sources are build "
                    f"{key} ({variant()}, torch {torch.__version__})")
            _loaded = have["path"]
    return _loaded


_OPS: Dict[str, object] = {}


def op(name: str):
    """The op `leod_tpu_torch::<name>` (its default overload), the
    library loaded first."""
    found = _OPS.get(name)
    if found is None:
        load()
        found = _OPS[name] = getattr(torch.ops.leod_tpu_torch, name).default
    return found


class Counted:
    """A kernel wrapper, called as the function it wraps, whose
    `.launches` (settable, to 0 before a counted run) and `.plan` (the
    last launch's, None before the first) are the op library's counters
    for its op, so launches from an exported program count too."""

    def __init__(self, fn, name: str):
        functools.update_wrapper(self, fn)
        self._op = name

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        load()
        return artifact.launch_counts()[self._op]

    @launches.setter
    def launches(self, count: int) -> None:
        op("set_launch_count")(self._op, count)

    @property
    def plan(self):
        plan = list(op("last_plan")(self._op))
        return None if not plan else plan[0] if len(plan) == 1 else \
            tuple(plan)


def counted(name: str):
    """Decorate the wrapper of op `name` with the library's counters."""
    return lambda fn: Counted(fn, name)
