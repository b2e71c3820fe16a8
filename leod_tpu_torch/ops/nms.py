"""Fixed-shape NMS and YOLOX postprocessing (port of
`leod_tpu/ops/nms.py:29-117`).

`nms_mask` here is the plain PyTorch version of the keep mask; the CUDA
kernel that replaces the Pallas `nms_mask_pallas` is `ops/nms_cuda.py`.
`postprocess` goes through the kernel's wrapper, which runs this plain
version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .boxes import cxcywh_to_xyxy, pairwise_iou


def nms_mask(boxes_xyxy: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor,
             class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask over score-DESCENDING-sorted inputs.

    boxes_xyxy [..., K, 4], valid [..., K] bool, class_ids [..., K]
    (suppression only between equal ids, exactly) -> keep [..., K] bool.
    A kept box i suppresses every later j with IoU > threshold."""
    k = boxes_xyxy.shape[-2]
    suppress = pairwise_iou(boxes_xyxy, boxes_xyxy) > iou_threshold
    if class_ids is not None:
        suppress &= class_ids[..., None, :] == class_ids[..., :, None]
    idx = torch.arange(k, device=boxes_xyxy.device)
    suppress &= idx[None, :] > idx[:, None]               # j strictly after i
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[..., i, :] & keep[..., i:i + 1])
    return keep


def nms_candidates(predictions: torch.Tensor, num_classes: int,
                   conf_threshold: float = 0.1, pre_topk: int = 1000
                   ) -> Tuple[torch.Tensor, ...]:
    """The top-k candidates of each image that the NMS takes, in score
    order: (boxes [B, k, 4] xyxy, valid [B, k], class ids [B, k] as
    floats, obj [B, k], class confidence [B, k]); k = min(pre_topk, A)."""
    predictions = predictions.float()
    bsz, a = predictions.shape[:2]
    boxes = cxcywh_to_xyxy(predictions[..., :4])          # [B, A, 4]
    obj = predictions[..., 4]
    # torch.max returns the first index of the maximum, as jnp.argmax
    cls_conf, cls_id = predictions[..., 5:5 + num_classes].max(dim=-1)
    cls_id = cls_id.float()
    score = obj * cls_conf
    sort_score = torch.where(score >= conf_threshold, score,
                             torch.full_like(score, -float("inf")))
    # jax.lax.top_k breaks ties by lower index: a stable descending sort
    k = min(pre_topk, a)
    order = torch.sort(sort_score, dim=1, descending=True,
                       stable=True).indices[:, :k]
    top_score = sort_score.gather(1, order)
    b = boxes.gather(1, order[..., None].expand(bsz, k, 4)).contiguous()
    return (b, torch.isfinite(top_score), cls_id.gather(1, order).contiguous(),
            obj.gather(1, order), cls_conf.gather(1, order))


def postprocess(predictions: torch.Tensor, num_classes: int,
                conf_threshold: float = 0.1, nms_threshold: float = 0.45,
                pre_topk: int = 1000, max_dets: int = 300,
                class_agnostic: bool = False, plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """YOLOX postprocess with fixed output shapes.

    predictions: [B, A, 4 + 1 + num_classes], (cx, cy, w, h) absolute,
    obj and class probabilities. Returns dets [B, max_dets, 7] =
    (x0, y0, x1, y1, obj_conf, cls_conf, cls_id) and valid [B, max_dets].
    plain=True runs the plain NMS even for CUDA tensors (the reference
    the kernel is held against)."""
    from .nms_cuda import nms_mask as nms_kernel

    b, valid, cls_sel, obj, cls_conf = nms_candidates(
        predictions, num_classes, conf_threshold, pre_topk)
    bsz, k = valid.shape
    ids = None if class_agnostic else cls_sel
    keep = (nms_mask(b, nms_threshold, valid, ids) if plain
            else nms_kernel(b, nms_threshold, valid, ids))
    det = torch.cat([b, obj[..., None], cls_conf[..., None],
                     cls_sel[..., None]], dim=-1)           # [B, k, 7]
    # kept rows to the front, in score order
    perm = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    if k < max_dets:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_dets - k))
        perm = torch.nn.functional.pad(perm, (0, max_dets - k),
                                       value=max_dets - 1)
    out = det.gather(1, perm[:, :max_dets, None].expand(bsz, max_dets, 7))
    n_kept = keep.sum(dim=1).clamp(max=max_dets)
    out_valid = (torch.arange(max_dets, device=out.device)[None, :]
                 < n_kept[:, None])
    out = torch.where(out_valid[..., None], out, torch.zeros_like(out))
    return out, out_valid
