"""Port of the Pallas kernel `nms_mask_pallas`
(`leod_tpu/ops/nms_pallas.py:65`) to hand-written CUDA for Hopper
(`csrc/nms.cu`): a suppression-mask build, a warp for each 32-row by
32-column word tile on or above the diagonal of every image (a lane a
column, `__ballot_sync` forming each row's word), then one sweep warp
per image that resolves the greedy 32 boxes (one mask word) at a time,
its row tiles streamed into shared memory by bulk copies, in one call
per batch.

The launch is the `torch.library` custom op `leod_tpu_torch::nms_mask`:
for a CPU tensor it runs the plain version (`ops/nms.py` `nms_mask`),
for a CUDA tensor it launches the kernel or raises, and its fake
implementation gives `torch.export` the keep mask's shape. The CUDA
implementation counts its launches in `nms_mask.launches`, so launches
made from an exported graph count too.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .nms import nms_mask as nms_mask_plain

_P = ctypes.c_void_p
_SIGS = {"leod_nms_mask": [_P, _P, _P, ctypes.c_float, ctypes.c_int,
                           ctypes.c_int, _P, _P, _P]}
MAX_K = 1024


_LIB = torch.library.Library("leod_tpu_torch", "FRAGMENT")
_LIB.define("nms_mask(Tensor boxes, float iou_threshold, Tensor valid, "
            "Tensor? class_ids) -> Tensor")


def _nms_cuda(boxes_xyxy, iou_threshold, valid, class_ids):
    squeeze = boxes_xyxy.dim() == 2
    if squeeze:
        boxes_xyxy, valid = boxes_xyxy[None], valid[None]
        class_ids = None if class_ids is None else class_ids[None]
    bsz, k, _ = boxes_xyxy.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"nms_mask: the CUDA kernel takes 1..{MAX_K} "
                         f"boxes an image, got {k}")
    boxes = boxes_xyxy.float().contiguous()
    if boxes.data_ptr() % 16:         # the kernel reads a box as one float4
        boxes = boxes.clone()
    valid_u8 = valid.to(torch.uint8).contiguous()
    ids = None if class_ids is None else class_ids.float().contiguous()
    for t in (valid_u8, ids):
        if t is not None and (t.device != boxes.device
                              or t.shape != (bsz, k)):
            raise ValueError("nms_mask: valid/class_ids must be [B, K] on "
                             "the boxes' device")
    keep = torch.empty((bsz, k), dtype=torch.uint8, device=boxes.device)
    # the kernels' scratch: the suppression bitmask, ceil(K/32) words a
    # row in rows of 32 (the sweep's bulk copies move whole rows),
    # written and read only on and above the diagonal
    mask = torch.empty((bsz, k, 32), dtype=torch.int32, device=boxes.device)
    lib = _build.load("nms", _SIGS)
    _build.check("leod_nms_mask", lib.leod_nms_mask(
        boxes.data_ptr(), valid_u8.data_ptr(),
        None if ids is None else ids.data_ptr(), float(iou_threshold), bsz,
        k, mask.data_ptr(), keep.data_ptr(),
        torch.cuda.current_stream(boxes.device).cuda_stream))
    nms_mask.launches += 1
    keep = keep.bool()
    return keep[0] if squeeze else keep


_LIB.impl("nms_mask", nms_mask_plain, "CPU")
_LIB.impl("nms_mask", _nms_cuda, "CUDA")


@torch.library.register_fake("leod_tpu_torch::nms_mask", lib=_LIB)
def _nms_fake(boxes_xyxy, iou_threshold, valid, class_ids):
    return torch.empty(valid.shape, dtype=torch.bool, device=valid.device)


_OP = torch.ops.leod_tpu_torch.nms_mask.default


def nms_mask(boxes_xyxy: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor,
             class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask: boxes [B, K, 4] (or [K, 4]) sorted by score
    descending, valid [B, K] bool, class_ids [B, K] or None ->
    keep [B, K] bool."""
    return _OP(boxes_xyxy, float(iou_threshold), valid, class_ids)


nms_mask.launches = 0

WRAPPERS = (nms_mask,)
