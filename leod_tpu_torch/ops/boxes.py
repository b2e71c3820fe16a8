"""Box geometry (port of `leod_tpu/ops/boxes.py:17-62`).

Formats:
  xyxy    : [x0, y0, x1, y1]
  cxcywh  : [center_x, center_y, w, h]

Floors and clamps against a constant are `maximum`/`minimum`: their
gradient splits at a tie, as `jnp.maximum`'s does, where `torch.clamp`
passes it whole.
"""
from __future__ import annotations

import torch


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """Elementwise max(x, c) for a constant c, with jnp.maximum's
    gradient (half to each side at a tie)."""
    return torch.maximum(x, x.new_tensor(c))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """Elementwise min(x, c) for a constant c, with jnp.minimum's
    gradient."""
    return torch.minimum(x, x.new_tensor(c))


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack(
        [0.5 * (x0 + x1), 0.5 * (y0 + y1), x1 - x0, y1 - y0], dim=-1)


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
    return inter / maximum(union, 1e-16)


def elementwise_iou(a: torch.Tensor, b: torch.Tensor,
                    fmt: str = "cxcywh") -> torch.Tensor:
    """IoU for matched pairs a[..., 4] vs b[..., 4] -> [...]."""
    if fmt == "cxcywh":
        a = cxcywh_to_xyxy(a)
        b = cxcywh_to_xyxy(b)
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    valid = (tl < br).all(dim=-1)
    inter = torch.prod(br - tl, dim=-1) * valid
    area_a = torch.prod(a[..., 2:] - a[..., :2], dim=-1)
    area_g = torch.prod(b[..., 2:] - b[..., :2], dim=-1)
    return inter / maximum(area_a + area_g - inter, 1e-16)
