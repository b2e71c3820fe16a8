"""Port of the Pallas kernel `nms_mask_pallas`
(`leod_tpu/ops/nms_pallas.py:65`) to hand-written CUDA for Hopper
(`csrc/nms.cu`): a suppression-mask build, a warp for each 32-row by
32-column word tile on or above the diagonal of every image (a lane a
column, `__ballot_sync` forming each row's word), then one sweep warp
per image that resolves the greedy 32 boxes (one mask word) at a time,
its row tiles streamed into shared memory by bulk copies, in one call
per batch.

The launch is the custom op `leod_tpu_torch::nms_mask`, defined and
implemented in C++ (`csrc/torch_ops.cpp`): for a CPU tensor it runs the
plain version (the C++ twin of `ops/nms.py` `nms_mask`), for a CUDA
tensor it launches the kernel or raises, and its Meta implementation
gives `torch.export` the keep mask's shape. The library counts the CUDA
launches (`nms_mask.launches`), so launches made from an exported graph
count too.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


@_build.counted("nms_mask")
def nms_mask(boxes_xyxy: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor,
             class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask: boxes [B, K, 4] (or [K, 4]) sorted by score
    descending, valid [B, K] bool, class_ids [B, K] or None ->
    keep [B, K] bool."""
    return _build.op("nms_mask")(boxes_xyxy, float(iou_threshold), valid,
                                 class_ids)


WRAPPERS = (nms_mask,)
