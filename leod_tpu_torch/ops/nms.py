"""Fixed-shape NMS and YOLOX postprocessing (port of
`leod_tpu/ops/nms.py:29-117`).

`nms_mask` here is the plain PyTorch version of the keep mask; the CUDA
kernel that replaces the Pallas `nms_mask_pallas` is `ops/nms_cuda.py`.
`postprocess` goes through the kernel's wrapper, which runs this plain
version for CPU tensors. `nms_numpy` and `batched_nms_numpy` are the
host NMS the TTA merge and the pseudo-labeller run on numpy rows: the
C++ of `native/host_ops.cpp`, or a numpy loop with the same results.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Host NMS (numpy), for merging TTA views and pseudo labels
# ---------------------------------------------------------------------------


def nms_numpy(boxes_xyxy: np.ndarray, scores: np.ndarray,
              iou_threshold: float,
              class_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Host greedy NMS -> kept indices in score-descending order
    (`leod_tpu/ops/nms.py:120-146`).

    Runs the native `leod_nms` (`native/host_ops.cpp`) where the host
    library builds, as the JAX package does, and else this numpy loop of
    the same arithmetic: float32 boxes and areas, a stable descending
    score sort, IoU = inter / max(area_i + area_j - inter, 1e-16),
    suppression where IoU > threshold and only between boxes of equal
    `class_ids` where given. float32 numpy rounds each operation as that
    C++ does, so the kept indices are the same."""
    n = len(boxes_xyxy)
    if n == 0:
        return np.zeros((0,), np.int64)
    from ..native import nms as native_nms
    kept = native_nms(np.asarray(boxes_xyxy), np.asarray(scores),
                      None if class_ids is None else np.asarray(class_ids),
                      iou_threshold)
    if kept is not None:
        return kept
    b = np.asarray(boxes_xyxy, np.float32)
    s = np.asarray(scores, np.float32)
    order = np.argsort(-s, kind="stable")
    x0, y0, x1, y1 = b[order].T
    zero = np.float32(0.0)
    areas = np.maximum(zero, x1 - x0) * np.maximum(zero, y1 - y0)
    ids = (None if class_ids is None
           else np.asarray(class_ids, np.float32)[order])
    thr = np.float32(iou_threshold)
    alive = np.ones(n, bool)
    keep = []
    for i in range(n):
        if not alive[i]:
            continue
        keep.append(order[i])
        xx0 = np.maximum(x0[i], x0[i + 1:])
        yy0 = np.maximum(y0[i], y0[i + 1:])
        xx1 = np.minimum(x1[i], x1[i + 1:])
        yy1 = np.minimum(y1[i], y1[i + 1:])
        overlap = (xx0 < xx1) & (yy0 < yy1)
        inter = (xx1 - xx0) * (yy1 - yy0)
        iou = inter / np.maximum(areas[i] + areas[i + 1:] - inter,
                                 np.float32(1e-16))
        hit = overlap & (iou > thr)
        if ids is not None:
            hit &= ids[i + 1:] == ids[i]
        alive[i + 1:] &= ~hit
    return np.asarray(keep, np.int64)


def batched_nms_numpy(boxes_xyxy: np.ndarray, scores: np.ndarray,
                      class_ids: np.ndarray,
                      iou_threshold: float) -> np.ndarray:
    """Class-aware host NMS (`leod_tpu/ops/nms.py:149-161`): the native
    `leod_nms` with class ids, or its numpy twin. The JAX package's numpy
    fallback separates the classes by a coordinate offset of 1e5 in
    float64; its preferred native path, which this matches index for
    index, compares the class ids instead (that offset in float32 would
    round the boxes' coordinates)."""
    if len(boxes_xyxy) == 0:
        return np.zeros((0,), np.int64)
    return nms_numpy(boxes_xyxy, scores, iou_threshold, class_ids)
