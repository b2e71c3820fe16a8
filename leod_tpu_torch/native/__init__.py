"""The C++ host library (`host_ops.cpp`: greedy NMS and COCO per-image
matching), built with g++ at first use and loaded with ctypes (port of
`leod_tpu/native/__init__.py`).

The library is `leod_tpu_torch/_build/libleod_host-<hash>.so`, the hash
over the source and the flags, so an edited source builds anew; it is
compiled to a per-process temporary name and renamed into place, so a
process never loads a half-written file. Nothing is built when the
module is imported. Callers (`ops/nms.py`, `eval/coco.py`) fall back to
their numpy versions, which give the same results, when `get_lib()` is
None; `chip_smoke.py` fails then instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_ops.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libleod_host-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None if it cannot be built
    or loaded (the reason is printed once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = lib_path()
        try:
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"leod_tpu_torch.native: no host library ({e}); using "
                  f"the numpy versions")
            return None
        lib.leod_nms.restype = ctypes.c_int
        lib.leod_nms.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.leod_coco_eval_image.restype = None
        lib.leod_coco_eval_image.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def nms(boxes_xyxy: np.ndarray, scores: np.ndarray,
        class_ids: Optional[np.ndarray], iou_threshold: float
        ) -> Optional[np.ndarray]:
    """Native greedy NMS -> kept indices in score-descending order (only
    between equal `class_ids` where given); None if the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(boxes_xyxy)
    if n == 0:
        return np.zeros((0,), np.int64)
    b = np.ascontiguousarray(boxes_xyxy, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    c = np.ascontiguousarray(
        class_ids if class_ids is not None else np.zeros(n), np.float32)
    keep = np.zeros(n, np.int32)
    k = lib.leod_nms(_ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float),
                     _ptr(c, ctypes.c_float), n,
                     ctypes.c_float(iou_threshold),
                     int(class_ids is not None), _ptr(keep, ctypes.c_int))
    return keep[:k].astype(np.int64)


def coco_eval_image(dt_xywh: np.ndarray, gt_xywh: np.ndarray,
                    gt_ignore: np.ndarray, thrs: np.ndarray,
                    area_ranges: np.ndarray):
    """Native COCO per-image matching over ALL area ranges with the IoU
    matrix computed once; None if the library is unavailable.
    dt must be score-sorted desc (caller caps maxDet).
    Returns (dt_matched [A,T,D] bool, dt_ig [A,T,D] bool, npig [A] int)."""
    lib = get_lib()
    if lib is None:
        return None
    d, g, t = len(dt_xywh), len(gt_xywh), len(thrs)
    ar = np.ascontiguousarray(area_ranges, np.float64).reshape(-1, 2)
    a = len(ar)
    dt = np.ascontiguousarray(dt_xywh, np.float64)
    gt = np.ascontiguousarray(gt_xywh, np.float64)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    th = np.ascontiguousarray(thrs, np.float64)
    dtm = np.zeros((a, t, d), np.uint8)
    dt_ig = np.zeros((a, t, d), np.uint8)
    npig = np.zeros((a,), np.int32)
    lib.leod_coco_eval_image(
        _ptr(dt, ctypes.c_double), d, _ptr(gt, ctypes.c_double), g,
        _ptr(gi, ctypes.c_uint8), _ptr(th, ctypes.c_double), t,
        _ptr(ar, ctypes.c_double), a,
        _ptr(dtm, ctypes.c_uint8), _ptr(dt_ig, ctypes.c_uint8),
        _ptr(npig, ctypes.c_int32))
    return dtm.astype(bool), dt_ig.astype(bool), npig
