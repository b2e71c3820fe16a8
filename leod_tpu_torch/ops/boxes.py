"""Box geometry (port of `leod_tpu/ops/boxes.py:17-48`).

Formats:
  xyxy    : [x0, y0, x1, y1]
  cxcywh  : [center_x, center_y, w, h]
"""
from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., M, N] for xyxy a[..., M, 4] vs b[..., N, 4].

    Intersection counts only where strictly tl < br on both axes; the
    union is floored at 1e-16. Every product and sum is rounded on its
    own, in the reference's order, so the CUDA NMS kernel can match it
    bit for bit (`csrc/nms.cu` `iou_exceeds`)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])   # [M,N,2]
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = br - tl
    valid = (tl < br).all(dim=-1)
    inter = wh[..., 0] * wh[..., 1] * valid
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-16)
