"""SimOTA dynamic label assignment, batched over frames (port of
`leod_tpu/ops/simota.py:36-189`).

The JAX package re-derives YOLOX's per-image SimOTA loop
(reference: models/detection/yolox/models/yolo_head.py:606-774 and the
ignore-label variant :974-1148) as masked dense algebra over fixed
[G, A] matrices and vmaps it over frames; here the frame axis M leads
every tensor instead:

  * geometry gate: anchor center within +-1.5*stride of a GT center
    (strict inequalities)
  * candidate anchors = in-center of ANY valid GT; anchors in-center of
    only ignore-labeled GTs are excluded and flagged `ignore`
  * cost = cls-BCE(sqrt(sig(cls)*sig(obj)), onehot) + 3*(-log iou)
    + 1e6 * ~in-center
  * dynamic-k = clamp(int(sum top-10 IoU), min=1) per GT; the k
    lowest-cost candidates are matched, ties to the lower anchor index
  * anchors matched to >1 GT keep only the globally cheapest GT

The cls-BCE term is decomposed so the [M, G, A, C] tensor is never made:
BCE(p, onehot_g) summed over C = sum_c -log(1-p_c) + [-log p_{c_g} +
log(1-p_{c_g})].

The assignment is NOT cut from the gradient: `pred_iou`, the IoU of each
matched (prediction, GT) pair, is computed from the predicted boxes and
scales the loss's cls target, so the gradient reaches the boxes through
it, as `jax.grad` of the JAX loss does. Only the cost, which feeds masks
and indices alone, is computed from detached inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import cxcywh_to_xyxy, pairwise_iou
from .losses import bce_probs

_BIG = 1.0e15
_TOPK_IOU = 10


def _extract_k(x: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Values of the k largest/smallest entries along the last axis, in
    extraction (sorted) order, by k arg-extremum passes: each pass takes
    the first extremum (lowest index) and masks it out, so tied values
    come out in index order and the list equals the sorted one."""
    iota = torch.arange(x.shape[-1], device=x.device)
    fill = x.new_tensor(-float("inf") if largest else float("inf"))
    vs = []
    for _ in range(k):
        i = x.argmax(-1) if largest else x.argmin(-1)
        vs.append(torch.gather(x, -1, i[..., None])[..., 0])
        x = torch.where(iota == i[..., None], fill, x)
    return torch.stack(vs, dim=-1)                           # [..., k]


def _cheapest_k_mask(cost: torch.Tensor, dynamic_k: torch.Tensor,
                     K: int) -> torch.Tensor:
    """Mask of the dynamic_k cheapest entries per row, with stable rank
    semantics (ties broken by ascending index, as ranks from a double
    stable argsort), without sorting. Requires dynamic_k <= K.

    rank < k  <=>  cost < kth   OR   (cost == kth  AND
                   #ties-at-kth up to and incl. this entry <= k - #below)
    where kth is the k-th smallest value (duplicates counted)."""
    bot = _extract_k(cost, K, largest=False)                     # [..., K]
    kth = torch.gather(bot, -1, torch.clamp(dynamic_k - 1, 0, K - 1
                                            )[..., None].long())
    below = cost < kth
    eq = cost == kth
    tie_budget = dynamic_k[..., None] - below.sum(-1, keepdim=True)
    return below | (eq & (eq.cumsum(-1) <= tie_budget))


class AssignResult(NamedTuple):
    fg: torch.Tensor           # [M, A] bool — anchor is a matched foreground
    ignore: torch.Tensor       # [M, A] bool — excluded from objectness loss
    matched_gt: torch.Tensor   # [M, A] int — index of the matched GT (fg)
    pred_iou: torch.Tensor     # [M, A] — IoU of the matched (pred, GT) pair
    num_fg: torch.Tensor       # [M] — matched anchors a frame
    num_gt: torch.Tensor       # [M] — valid GTs a frame


def mark_low_conf_as_ignore(labels: torch.Tensor, thresh: torch.Tensor,
                            ignore_label: int) -> torch.Tensor:
    """Stamp `ignore_label` on pseudo boxes below per-class conf
    thresholds (reference: yolo_head.py:382-401). labels [..., G, 7] in
    the yolox layout; returns a new tensor."""
    cls_idx = labels[..., 0]
    obj_conf = labels[..., 5]
    cls_conf = labels[..., 6]
    per_box = thresh[torch.clamp(cls_idx.long(), 0, thresh.shape[0] - 1)]
    low = (obj_conf < per_box) | (cls_conf < per_box)
    nonpad = labels.sum(-1) > 0
    new_cls = torch.where(low & nonpad, cls_idx.new_tensor(
        float(ignore_label)), cls_idx)
    return torch.cat([new_cls[..., None], labels[..., 1:]], dim=-1)


def simota_assign(labels: torch.Tensor, pred_boxes: torch.Tensor,
                  obj_logits: torch.Tensor, cls_logits: torch.Tensor,
                  anchor_centers: torch.Tensor, anchor_strides: torch.Tensor,
                  num_classes: int, ignore_label: int = 1024
                  ) -> AssignResult:
    """Assign the anchors of M frames.

    labels        [M, G, 7]  yolox layout [cls, cx, cy, w, h, obj_c,
                             cls_c]; all-zero rows are padding
    pred_boxes    [M, A, 4]  decoded absolute (cx, cy, w, h)
    obj_logits    [M, A]
    cls_logits    [M, A, C]
    anchor_centers[A, 2]     (x, y) = (shift + 0.5) * stride
    anchor_strides[A]
    """
    f32 = torch.float32
    labels = labels.to(f32)
    gt_cls = labels[..., 0]
    gt_boxes = labels[..., 1:5]
    nonpad = labels.sum(-1) > 0                                  # [M, G]
    valid_gt = nonpad & (gt_cls != ignore_label)

    # --- geometry gate (strict, radius 1.5 strides) ---
    dist = 1.5 * anchor_strides                                  # [A]
    dx = anchor_centers[:, 0] - gt_boxes[..., 0, None]           # [M, G, A]
    dy = anchor_centers[:, 1] - gt_boxes[..., 1, None]
    in_center = (dx > -dist) & (dx < dist) & (dy > -dist) & (dy < dist)

    candidate = (in_center & valid_gt[..., None]).any(1)         # [M, A]
    covered_any = (in_center & nonpad[..., None]).any(1)
    ignore_anchor = covered_any & ~candidate

    # --- pairwise IoU (masked); differentiable in the predicted boxes ---
    iou = pairwise_iou(cxcywh_to_xyxy(gt_boxes),
                       cxcywh_to_xyxy(pred_boxes.to(f32)))       # [M, G, A]
    pair_ok = valid_gt[..., None] & candidate[:, None, :]
    iou = torch.where(pair_ok, iou, iou.new_zeros(()))
    iou_d = iou.detach()

    # --- classification cost without [M, G, A, C] ---
    p = torch.sqrt(torch.sigmoid(cls_logits.detach().to(f32)) *
                   torch.sigmoid(obj_logits.detach().to(f32))[..., None])
    neg = bce_probs(p, torch.zeros_like(p))                      # -log(1-p)
    pos = bce_probs(p, torch.ones_like(p))                       # -log(p)
    neg_sum = neg.sum(-1)                                        # [M, A]
    cls_idx = torch.clamp(gt_cls.long(), 0, num_classes - 1)     # [M, G]
    G, A = iou.shape[1:]
    delta = torch.gather((pos - neg).transpose(1, 2), 1,
                         cls_idx[..., None].expand(-1, G, A))    # [M, G, A]
    cls_cost = neg_sum[:, None, :] + delta

    cost = (cls_cost
            + 3.0 * (-torch.log(iou_d + 1e-8))
            + 1e6 * (~in_center).to(f32))
    cost = torch.where(pair_ok, cost, cost.new_tensor(_BIG))

    # --- dynamic-k from the top-10 IoU mass per GT ---
    K = min(_TOPK_IOU, A)
    topk_iou = _extract_k(iou_d, K, largest=True)                # [M, G, K]
    dynamic_k = torch.clamp(topk_iou.sum(-1).to(torch.int32), min=1)
    dynamic_k = torch.where(valid_gt, dynamic_k, dynamic_k.new_zeros(()))

    # --- k cheapest candidates per GT (stable rank < k, sort-free) ---
    matching = _cheapest_k_mask(cost, dynamic_k, K) & (cost < _BIG / 2)

    # --- conflict resolution: the globally cheapest GT wins the anchor ---
    conflict = matching.sum(1) > 1                               # [M, A]
    best_g = cost.argmin(1)                                      # [M, A]
    g_idx = torch.arange(G, device=cost.device)
    matching = torch.where(conflict[:, None, :],
                           g_idx[:, None] == best_g[:, None, :], matching)

    fg = matching.any(1)
    matched_gt = matching.to(torch.int32).argmax(1)
    pred_iou = (matching * iou).sum(1)
    return AssignResult(fg=fg, ignore=ignore_anchor, matched_gt=matched_gt,
                        pred_iou=pred_iou, num_fg=fg.sum(-1),
                        num_gt=valid_gt.sum(-1))
