"""Plain PyTorch YOLOX loss with SimOTA assignment, and the optimizer
step: the benchmark's reference for a training step.

A frozen copy of the arithmetic LEOD trains with
(`models/detection/yolox/models/yolo_head.py`: SimOTA's centre gate of
1.5 strides, the cost cls-BCE + 3 * -log IoU, dynamic k from the top-10
IoU mass, the cheapest GT winning a contested anchor; the loss
5 * (1 - IoU^2) + BCE objectness + BCE class against the IoU-scaled one
hot, each over the number of foreground anchors), then gradient
clipping by value and AdamW (`train.py`, `modules/detection.py`: a
linear OneCycle schedule whose floor is max_lr / final_div_factor).
Frames are batched along a leading axis; all-zero label rows pad.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def _cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _pair_iou(a, b):
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = br - tl
    inter = wh[..., 0] * wh[..., 1] * (tl < br).all(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    ).clamp(min=1e-16)


def _iou(a, b):
    a, b = _cxcywh_to_xyxy(a), _cxcywh_to_xyxy(b)
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    inter = torch.prod(br - tl, -1) * (tl < br).all(-1)
    aa = torch.prod(a[..., 2:] - a[..., :2], -1)
    ab = torch.prod(b[..., 2:] - b[..., :2], -1)
    return inter / (aa + ab - inter).clamp(min=1e-16)


def _bce_logits(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _bce_probs(p, t):
    logp = torch.log(p.clamp(min=1e-12)).clamp(min=-100)
    log1mp = torch.log((1 - p).clamp(min=1e-12)).clamp(min=-100)
    return -(t * logp + (1 - t) * log1mp)


def simota(labels, boxes, obj, cls, centers, strides, num_classes):
    """(fg [M, A], matched gt [M, A], IoU of the matched pair [M, A],
    with its gradient to the boxes). labels [M, G, 7]
    [cls, cx, cy, w, h, obj, cls_conf]."""
    gt_cls, gt = labels[..., 0], labels[..., 1:5]
    valid = labels.sum(-1) > 0
    dist = 1.5 * strides
    dx = centers[:, 0] - gt[..., 0, None]
    dy = centers[:, 1] - gt[..., 1, None]
    inc = (dx > -dist) & (dx < dist) & (dy > -dist) & (dy < dist)
    cand = (inc & valid[..., None]).any(1)
    iou = _pair_iou(_cxcywh_to_xyxy(gt), _cxcywh_to_xyxy(boxes))
    ok = valid[..., None] & cand[:, None, :]
    iou = torch.where(ok, iou, torch.zeros_like(iou))
    iou_d = iou.detach()
    p = torch.sqrt(torch.sigmoid(cls.detach()) *
                   torch.sigmoid(obj.detach())[..., None])          # [M, A, C]
    onehot = F.one_hot(gt_cls.long().clamp(0, num_classes - 1),
                       num_classes).float()                         # [M, G, C]
    cls_cost = _bce_probs(p[:, None], onehot[:, :, None]).sum(-1)   # [M, G, A]
    cost = cls_cost + 3.0 * -torch.log(iou_d + 1e-8) + 1e6 * (~inc).float()
    cost = torch.where(ok, cost, torch.full_like(cost, 1e15))
    k = min(10, iou.shape[-1])
    dyn = torch.topk(iou_d, k, -1).values.sum(-1).to(torch.int32).clamp(min=1)
    dyn = torch.where(valid, dyn, torch.zeros_like(dyn))
    # the dyn cheapest candidates of each GT, ties to the lower index
    order = torch.sort(cost, dim=-1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(cost.shape[-1], device=cost.device
                                          ).expand_as(order))
    match = (rank < dyn[..., None]) & (cost < 1e15 / 2)
    conflict = match.sum(1) > 1
    best = cost.argmin(1)
    g = torch.arange(cost.shape[1], device=cost.device)
    match = torch.where(conflict[:, None], g[:, None] == best[:, None], match)
    fg = match.any(1)
    return fg, match.to(torch.int32).argmax(1), (match * iou).sum(1)


def yolox_loss(out, labels, frame_mask, centers, strides, num_classes):
    """(total loss, its terms and the matched anchors a GT) over M
    frames: out [M, A, 5 + C] decoded boxes with logits, labels
    [M, G, 7], frame_mask [M]."""
    boxes, obj, cls = out[..., :4], out[..., 4], out[..., 5:]
    fg, mgt, piou = simota(labels, boxes, obj, cls, centers, strides,
                           num_classes)
    fg = fg & frame_mask[:, None]
    fgf = fg.float()
    denom = fgf.sum().clamp(min=1.0)
    gtb = torch.gather(labels[..., 1:5], 1, mgt.long()[..., None].expand(
        -1, -1, 4))
    l_iou = ((1 - _iou(boxes, gtb) ** 2) * fgf).sum() / denom
    l_obj = (_bce_logits(obj, fgf) * frame_mask[:, None]).sum() / denom
    ci = torch.gather(labels[..., 0], 1, mgt.long()).long().clamp(
        0, num_classes - 1)
    tgt = F.one_hot(ci, num_classes).float() * piou[..., None]
    l_cls = (_bce_logits(cls, tgt) * fgf[..., None]).sum() / denom
    num_gt = ((labels.sum(-1) > 0) & frame_mask[:, None]).sum().clamp(min=1)
    return 5.0 * l_iou + l_obj + l_cls, {
        "iou_loss": 5.0 * l_iou.detach(), "conf_loss": l_obj.detach(),
        "cls_loss": l_cls.detach(), "num_fg": fgf.sum() / num_gt}


def _linear(init, end, steps, count):
    f32 = np.float32
    c = min(max(count, 0), steps)
    return float(f32(init - end) * (f32(1.0) - f32(c) / f32(steps)) + f32(end))


def onecycle_lr(train: Dict, count: int) -> float:
    """The learning rate of update `count` (from 0): linear warm-up from
    max_lr / div_factor over round(total * pct_start) - 1 updates, then
    linear decay to max_lr / final_div_factor at the last."""
    max_lr, total = train["learning_rate"], train["max_steps"]
    warm = max(round(total * train["pct_start"]) - 1, 1)
    if count < warm:
        return _linear(max_lr / train["div_factor"], max_lr, warm, count)
    return _linear(max_lr, max_lr / train["final_div_factor"],
                   max(total - 1 - warm, 1), count - warm)


class AdamW:
    """Clip every gradient to [-clip, clip], then AdamW (b1 0.9,
    b2 0.999, eps 1e-8, decoupled weight decay) at `onecycle_lr`."""

    def __init__(self, params: List[torch.Tensor], train: Dict):
        self.params = params
        self.train = train
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Updates the parameters in place; returns the clipped
        gradients."""
        clip = self.train["gradient_clip_val"]
        lr = onecycle_lr(self.train, self.count)
        wd = self.train["weight_decay"]
        t = self.count + 1
        out = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.clamp(-clip, clip)
            out.append(g)
            p.mul_(1 - lr * wd)
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (v / (1 - 0.999 ** t)).sqrt() + 1e-8
            p.addcdiv_(m / (1 - 0.9 ** t), denom, value=-lr)
        self.count += 1
        return out
