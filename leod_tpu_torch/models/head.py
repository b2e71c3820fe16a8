"""YOLOX decoupled head, box decoding and the SimOTA training loss (port
of `leod_tpu/models/head.py:34-236`).

The loss is one batched masked computation over [M, A] (M = harvested
frames, A = anchors), with LEOD's ignore-region variant (reference:
yolo_head.py:776-972) folded in as an anchor mask; the plain path is the
special case with no ignore boxes.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HeadConfig
from ..ops.boxes import maximum
from ..ops.losses import bce_with_logits, iou_loss, sigmoid_focal_loss
from ..ops.simota import mark_low_conf_as_ignore, simota_assign
from ..parallel.distributed import global_sum
from .layers import ConvBNAct, DWConvBlock, _nchw, _nhwc

PRIOR_PROB = 0.01
PRIOR_BIAS = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)


class Anchors(NamedTuple):
    centers: torch.Tensor   # [A, 2] pixel centers: (shift + 0.5) * stride
    shifts: torch.Tensor    # [A, 2] integer grid shifts (x, y)
    strides: torch.Tensor   # [A]
    hw: Tuple[Tuple[int, int], ...]


def make_anchors(in_res_hw: Tuple[int, int], strides: Sequence[int],
                 device="cpu") -> Anchors:
    centers, shifts, strs, hw = [], [], [], []
    for s in strides:
        h, w = in_res_hw[0] // s, in_res_hw[1] // s
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        sh = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).float()
        shifts.append(sh)
        centers.append((sh + 0.5) * s)
        strs.append(torch.full((h * w,), float(s)))
        hw.append((h, w))
    return Anchors(torch.cat(centers).to(device), torch.cat(shifts).to(device),
                   torch.cat(strs).to(device), tuple(hw))


class YOLOXHead(nn.Module):
    """Per-scale stems + decoupled cls/reg branches. Returns raw maps
    [B, h, w, 5+C] per level, channel layout (reg 4, obj 1, cls C)."""

    def __init__(self, cfg: HeadConfig, in_channels: Tuple[int, ...]):
        super().__init__()
        self.cfg = cfg
        self.num_levels = len(in_channels)
        # width follows in_channels[-1]/1024 scaling (head.py:61)
        hidden = int(256 * (in_channels[-1] / 1024))
        conv = DWConvBlock if cfg.depthwise else ConvBNAct
        for k, cin in enumerate(in_channels):
            setattr(self, f"stem{k}", ConvBNAct(cin, hidden, 1, act=cfg.act))
            for j in range(2):
                setattr(self, f"cls_conv{k}_{j}",
                        conv(hidden, hidden, 3, act=cfg.act))
                setattr(self, f"reg_conv{k}_{j}",
                        conv(hidden, hidden, 3, act=cfg.act))
            setattr(self, f"cls_pred{k}", nn.Conv2d(hidden, cfg.num_classes, 1))
            setattr(self, f"reg_pred{k}", nn.Conv2d(hidden, 4, 1))
            setattr(self, f"obj_pred{k}", nn.Conv2d(hidden, 1, 1))

    def forward(self, fpn_feats, train: bool = False):
        """train=True normalizes with batch statistics and updates the
        BNs' running statistics (`ConvBNAct`)."""
        outs = []
        for k, x in enumerate(fpn_feats):
            x = getattr(self, f"stem{k}")(x, train)
            cls_f = reg_f = x
            for j in range(2):
                cls_f = getattr(self, f"cls_conv{k}_{j}")(cls_f, train)
                reg_f = getattr(self, f"reg_conv{k}_{j}")(reg_f, train)
            cls_out = getattr(self, f"cls_pred{k}")(_nchw(cls_f))
            reg_f = _nchw(reg_f)
            reg_out = getattr(self, f"reg_pred{k}")(reg_f)
            obj_out = getattr(self, f"obj_pred{k}")(reg_f)
            outs.append(_nhwc(torch.cat([reg_out, obj_out, cls_out], 1)))
        return outs


def decode_outputs(raw_levels, anchors: Anchors,
                   apply_sigmoid: bool) -> torch.Tensor:
    """Flatten + decode to absolute boxes [B, A, 4 + 1 + C] (fp32):
    xy = (pred + shift) * stride; wh = exp(pred) * stride; obj/cls stay
    logits unless `apply_sigmoid`."""
    flat = torch.cat([x.reshape(x.shape[0], -1, x.shape[-1])
                      for x in raw_levels], dim=1)
    st = anchors.strides[:, None]
    xy = (flat[..., 0:2] + anchors.shifts) * st
    wh = torch.exp(flat[..., 2:4]) * st
    rest = flat[..., 4:]
    if apply_sigmoid:
        rest = torch.sigmoid(rest)
    return torch.cat([xy, wh, rest.float()], dim=-1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [M, G] gathered at idx [M, A] along G -> [M, A]."""
    return torch.gather(x, 1, idx.long())


def _bbox_loss_weights(cfg: HeadConfig, labels: torch.Tensor,
                       matched_gt: torch.Tensor, fg: torch.Tensor,
                       num_fg: torch.Tensor) -> torch.Tensor:
    """Teacher-confidence bbox loss weights, mean-normalized over all fg
    of the batch (`num_fg` of them; under data parallelism the global
    batch's) (reference: yolo_head.py:358-380,550-555). Returns [M, A]."""
    spec = cfg.bbox_loss_weighting
    if not spec:
        return torch.ones(fg.shape, device=fg.device)
    val, _, expr = spec.partition("-")
    obj_c = _take(labels[..., 5], matched_gt)
    cls_c = _take(labels[..., 6], matched_gt)
    w = {"obj": obj_c, "cls": cls_c, "objxcls": obj_c * cls_c}[val]
    if expr == "w**2":
        w = w ** 2
    mean = global_sum((w * fg.float()).sum()) / maximum(num_fg, 1.0)
    return w / maximum(mean, 1e-12)


def _top_bg_ignore_mask(cfg: HeadConfig, obj_logits: torch.Tensor,
                        fg: torch.Tensor) -> torch.Tensor:
    """Exclude the top-k%-scoring background anchors of each frame from
    the objectness loss (reference: yolo_head.py:334-356), ranked by a
    stable double argsort, ties to the lower anchor index. Applied
    whether or not the batch holds ignore boxes, as `leod_tpu` does
    (`leod_tpu/models/head.py:125-133`)."""
    if cfg.ignore_bg_k <= 0:
        return torch.zeros(fg.shape, dtype=torch.bool, device=fg.device)
    bg = ~fg
    n = (bg.sum(1).float() * cfg.ignore_bg_k).to(torch.int32)      # [M]
    score = torch.where(bg, obj_logits.detach(),
                        obj_logits.new_tensor(-float("inf")))
    order = torch.argsort(-score, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return bg & (rank < n[:, None])


def yolox_loss(train_out: torch.Tensor, labels: torch.Tensor,
               frame_mask: torch.Tensor, anchors: Anchors,
               cfg: HeadConfig) -> Dict[str, torch.Tensor]:
    """SimOTA-assigned detection loss over M harvested frames, in fp32.

    train_out [M, A, 5+C] decoded boxes + obj/cls logits
    labels    [M, G, 7] yolox layout, zero rows = padding
    frame_mask[M] bool — padded frame slots contribute nothing

    total = 5 * iou + 1 * obj + 1 * cls (+ l1), each summed over the
    batch and divided by max(total_fg, 1) (under data parallelism the
    global batch's total_fg: the global loss is then the SUM of the
    ranks' losses, `train/step.py`); the obj BCE skips
    ignore-region anchors (reference: yolo_head.py:563-597, :940-972).
    The gradient reaches the boxes through the cls target's IoU as well
    (`ops/simota.py`)."""
    f32 = torch.float32
    train_out = train_out.to(f32)
    labels = labels.to(f32)
    if cfg.ignore_bbox_thresh is not None:
        labels = mark_low_conf_as_ignore(
            labels, labels.new_tensor(cfg.ignore_bbox_thresh),
            cfg.ignore_label)

    boxes = train_out[..., :4]
    obj_logits = train_out[..., 4]
    cls_logits = train_out[..., 5:]
    num_classes = cls_logits.shape[-1]
    assign = simota_assign(labels, boxes, obj_logits, cls_logits,
                           anchors.centers, anchors.strides,
                           num_classes=num_classes,
                           ignore_label=cfg.ignore_label)

    fm = frame_mask.bool()
    fg = assign.fg & fm[:, None]                                 # [M, A]
    fg_f = fg.to(f32)
    # the batch's counts: under data parallelism every rank's rows
    # (`parallel.distributed.global_batch`), so that each rank's loss is
    # its share of the global batch's
    num_fg, num_gt = global_sum(torch.stack(
        [fg_f.sum(), (assign.num_gt * fm).sum().to(f32)])).unbind()
    denom = maximum(num_fg, 1.0)

    # regression: 1 - IoU^2 on matched pairs
    idx = assign.matched_gt.long()[..., None]
    gt_boxes = torch.gather(labels[..., 1:5], 1,
                            idx.expand(-1, -1, 4))               # [M, A, 4]
    bbox_w = _bbox_loss_weights(cfg, labels, assign.matched_gt, fg, num_fg)
    loss_iou = (iou_loss(boxes, gt_boxes) * bbox_w * fg_f).sum() / denom

    # objectness: BCE against the fg indicator, skipping ignore anchors,
    # padded frames, and optionally the top-k% confident background
    bg_ignore = _top_bg_ignore_mask(cfg, obj_logits, fg)
    obj_valid = fm[:, None] & ~assign.ignore & ~bg_ignore
    obj_fn = sigmoid_focal_loss if cfg.obj_focal_loss else bce_with_logits
    loss_obj = (obj_fn(obj_logits, fg_f) * obj_valid).sum() / denom

    # classification: BCE against the IoU-scaled one-hot on fg anchors
    cls_idx = torch.clamp(_take(labels[..., 0], assign.matched_gt).long(),
                          0, num_classes - 1)
    cls_target = (F.one_hot(cls_idx, num_classes).to(f32)
                  * assign.pred_iou[..., None])
    loss_cls = (bce_with_logits(cls_logits, cls_target)
                * (bbox_w * fg_f)[..., None]).sum() / denom

    # optional L1 on the raw reg outputs against grid-space targets
    # (reference: yolo_head.py:560-580,599-605); decoding inverts
    # exactly, so the raw residual is |xy - gt_xy| / stride and
    # |log(wh / stride) - log(gt_wh / stride + eps)|
    loss_l1 = train_out.new_zeros(())
    if cfg.use_l1:
        st = anchors.strides[None, :, None]
        l1 = torch.cat([
            torch.abs(boxes[..., 0:2] - gt_boxes[..., 0:2]) / st,
            torch.abs(torch.log(maximum(boxes[..., 2:4], 1e-20) / st)
                      - torch.log(gt_boxes[..., 2:4] / st + 1e-8)),
        ], dim=-1)
        loss_l1 = (l1 * (bbox_w * fg_f)[..., None]).sum() / denom

    loss_iou = cfg.reg_weight * loss_iou
    loss_obj = cfg.obj_weight * loss_obj
    loss_cls = cfg.cls_weight * loss_cls
    out = {
        "loss": loss_iou + loss_obj + loss_cls + loss_l1,
        "iou_loss": loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "num_fg": num_fg / maximum(num_gt, 1.0),
    }
    if cfg.use_l1:
        out["l1_loss"] = loss_l1
    return out
