"""Detection losses (port of `leod_tpu/ops/losses.py:15-67`).

Reference semantics: models/detection/yolox/models/losses.py and the
loss assembly in yolo_head.py:563-597. All functions are elementwise or
masked, so they compose with static-shape batching. Clamps against a
constant are `maximum`/`minimum`, whose gradient splits at a tie as
`jnp.maximum`'s does (`torch.clamp` passes it whole).
"""
from __future__ import annotations

import torch

from .boxes import elementwise_iou, maximum, minimum


def iou_loss(pred_cxcywh: torch.Tensor,
             target_cxcywh: torch.Tensor) -> torch.Tensor:
    """1 - IoU^2 per box (reference: losses.py:40-41). Inputs [..., 4]."""
    iou = elementwise_iou(pred_cxcywh, target_cxcywh, fmt="cxcywh")
    return 1.0 - iou ** 2


def giou_loss(pred_cxcywh: torch.Tensor,
              target_cxcywh: torch.Tensor) -> torch.Tensor:
    """1 - GIoU per box (reference: losses.py:42-51)."""
    p0 = pred_cxcywh[..., :2] - pred_cxcywh[..., 2:] / 2
    p1 = pred_cxcywh[..., :2] + pred_cxcywh[..., 2:] / 2
    g0 = target_cxcywh[..., :2] - target_cxcywh[..., 2:] / 2
    g1 = target_cxcywh[..., :2] + target_cxcywh[..., 2:] / 2
    tl = torch.maximum(p0, g0)
    br = torch.minimum(p1, g1)
    inter = torch.prod(br - tl, -1) * (tl < br).all(-1)
    area_p = torch.prod(pred_cxcywh[..., 2:], -1)
    area_g = torch.prod(target_cxcywh[..., 2:], -1)
    union = area_p + area_g - inter
    iou = inter / maximum(union, 1e-16)
    c_tl = torch.minimum(p0, g0)
    c_br = torch.maximum(p1, g1)
    area_c = maximum(torch.prod(c_br - c_tl, -1), 1e-16)
    giou = iou - (area_c - union) / area_c
    return 1.0 - minimum(maximum(giou, -1.0), 1.0)


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Numerically-stable elementwise BCE-with-logits, in the JAX
    package's form (so its gradient is the same expression's)."""
    return (maximum(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """torchvision.ops.sigmoid_focal_loss semantics (reference:
    losses.py:69-85)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def bce_probs(probs: torch.Tensor, targets: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """BCE on probabilities with the log clamped at -100, as
    torch.nn.functional.binary_cross_entropy clamps it (SimOTA's cls
    cost on sqrt(sigmoid * sigmoid) probabilities, reference:
    yolo_head.py:660-668)."""
    logp = maximum(torch.log(maximum(probs, eps)), -100.0)
    log1mp = maximum(torch.log(maximum(1.0 - probs, eps)), -100.0)
    return -(targets * logp + (1.0 - targets) * log1mp)
