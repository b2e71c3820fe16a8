"""Pseudo-label filtering and quality evaluation (host, numpy); a copy of
`leod_tpu/selftrain/filters.py`, which the port does not import.

Reference: modules/utils/ssod.py — per-class confidence thresholds,
FOV cropping, conservative min-side filter, faulty-huge-box filter,
prediction -> pseudo-label conversion (t == 0 stamp), GT/pseudo merging,
and the teacher-quality AR/AP metrics.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..data.labels import Boxes

DATASET_HW = {"gen1": (240, 304), "gen4": (720, 1280)}


def subsample_label_idx(L: int, use_every: int = -1,
                        remove_every: int = -1) -> Tuple[int, ...]:
    """Timestep indices whose labels to keep on pseudo-dense sequences
    (reference: ssod.py:19-37). Always includes the last frame; skips the
    first (random-access windows warm-start there)."""
    assert use_every == -1 or remove_every == -1
    all_idx = list(range(L))
    if use_every == 1:
        return tuple(all_idx)
    if use_every > 0:
        use = all_idx[1::use_every]
    elif remove_every > 0:
        use = sorted(set(all_idx) - set(all_idx[::remove_every]))
    else:
        raise ValueError("either use_every or remove_every must be > 0")
    if L - 1 not in use:
        use.append(L - 1)
    return tuple(use)


def filter_pred_boxes_xyxy(xyxy: np.ndarray, dataset: str = "gen1",
                           downsampled_by_2: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """FOV-crop + conservative min-side(5) + max-width(90% frame) filters
    (reference: ssod.py:40-133). Returns (cropped_xyxy, keep_mask)."""
    h, w = DATASET_HW[dataset]
    if downsampled_by_2:
        h, w = h // 2, w // 2
    x1 = np.clip(xyxy[:, 0], 0, w - 1.0)
    y1 = np.clip(xyxy[:, 1], 0, h - 1.0)
    x2 = np.clip(xyxy[:, 2], 0, w - 1.0)
    y2 = np.clip(xyxy[:, 3], 0, h - 1.0)
    bw, bh = x2 - x1, y2 - y1
    keep = (bw > 0) & (bh > 0)
    keep &= (bw >= 5) & (bh >= 5)            # conservative filter
    keep &= bw <= (9 * w) // 10              # faulty huge boxes
    return np.stack([x1, y1, x2, y2], -1), keep


def filter_with_thresholds(scores: np.ndarray, class_ids: np.ndarray,
                           thresh: Union[float, Sequence[float]]) -> np.ndarray:
    """Strict > threshold, scalar or per-class (reference: ssod.py:136-144)."""
    if isinstance(thresh, float):
        return scores > thresh
    mask = np.zeros(scores.shape, bool)
    for i, t in enumerate(thresh):
        mask |= (class_ids == i) & (scores > t)
    return mask


def pred_to_label(pred: Optional[np.ndarray], hw: Tuple[float, float],
                  obj_thresh: Union[float, Sequence[float]] = 0.9,
                  cls_thresh: Union[float, Sequence[float]] = 0.9,
                  dataset: str = "gen1",
                  downsampled_by_2: bool = False,
                  apply_bbox_filter: bool = True) -> Boxes:
    """One frame's postprocessed detections -> pseudo-label Boxes.

    pred rows: (x1, y1, x2, y2, obj_conf, cls_conf, cls_id). Pseudo labels
    are stamped t == 0 (reference: ssod.py:147-188)."""
    if pred is None or len(pred) == 0:
        return Boxes.empty(hw)
    pred = np.asarray(pred, np.float32)
    obj_conf, cls_conf, cls_id = pred[:, 4], pred[:, 5], pred[:, 6]
    keep = (filter_with_thresholds(obj_conf, cls_id, obj_thresh)
            & filter_with_thresholds(cls_conf, cls_id, cls_thresh))
    xyxy = pred[:, :4]
    if apply_bbox_filter:
        xyxy, k2 = filter_pred_boxes_xyxy(xyxy, dataset, downsampled_by_2)
        keep &= k2
    out = np.zeros((int(keep.sum()), 8), np.float32)
    sel = np.where(keep)[0]
    out[:, 1] = xyxy[sel, 0]
    out[:, 2] = xyxy[sel, 1]
    out[:, 3] = xyxy[sel, 2] - xyxy[sel, 0]
    out[:, 4] = xyxy[sel, 3] - xyxy[sel, 1]
    out[:, 5] = cls_id[sel]
    out[:, 6] = cls_conf[sel]
    out[:, 7] = obj_conf[sel]
    return Boxes(out, hw)


def merge_labels(gt: List[Optional[Boxes]], pseudo: List[Optional[Boxes]]
                 ) -> Tuple[List[Optional[Boxes]], List[bool]]:
    """Keep GT where present, fill gaps with pseudo labels
    (reference: ssod.py:192-208)."""
    assert len(gt) == len(pseudo)
    out, gt_mask = [], []
    for g, p in zip(gt, pseudo):
        gt_mask.append(g is not None)
        out.append(g if g is not None else p)
    return out, gt_mask


def _iou_cxcywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a0 = a[:, :2] - a[:, 2:] / 2
    a1 = a[:, :2] + a[:, 2:] / 2
    b0 = b[:, :2] - b[:, 2:] / 2
    b1 = b[:, :2] + b[:, 2:] / 2
    tl = np.maximum(a0[:, None], b0[None])
    br = np.minimum(a1[:, None], b1[None])
    inter = np.prod(br - tl, -1) * np.all(tl < br, -1)
    ua = np.prod(a[:, 2:], -1)[:, None] + np.prod(b[:, 2:], -1)[None] - inter
    return inter / np.maximum(ua, 1e-12)


def evaluate_pseudo_labels(gt: List[Optional[Boxes]],
                           pseudo: List[Optional[Boxes]],
                           pred_mask: Sequence[bool], num_classes: int,
                           classes: Sequence[str],
                           thresholds=(0.25, 0.5, 0.75),
                           prefix: str = "") -> Dict[str, float]:
    """Teacher-quality AR/AP@IoU per class on frames where the teacher
    predicted (reference: ssod.py:209-281)."""
    per_cls = [[] for _ in range(num_classes)]
    n_gt = [[] for _ in range(num_classes)]
    n_pred = [[] for _ in range(num_classes)]
    for g, p, m in zip(gt, pseudo, pred_mask):
        if g is None or len(g) == 0 or not m:
            continue
        g_arr = g.to_yolox()
        p_arr = p.to_yolox() if p is not None else np.zeros((0, 7), np.float32)
        for c in range(num_classes):
            gb = g_arr[g_arr[:, 0] == c, 1:5]
            pb = p_arr[p_arr[:, 0] == c, 1:5]
            if len(gb) == 0:
                continue
            row = [0.0] * (2 * len(thresholds))
            if len(pb):
                ious = _iou_cxcywh(gb, pb)
                for ti, t in enumerate(thresholds):
                    m2 = ious > t
                    row[ti] = float(m2.any(1).mean())                 # recall
                    row[ti + len(thresholds)] = float(m2.any(0).mean())  # prec
            per_cls[c].append(row)
            n_gt[c].append(len(gb))
            n_pred[c].append(len(pb))
    out: Dict[str, float] = {}
    for c, rows in enumerate(per_cls):
        if not rows:
            continue
        name = classes[c]
        mean = np.asarray(rows).mean(0)
        out[f"num_{name}"] = float(len(rows))
        for ti, t in enumerate(thresholds):
            pct = int(t * 100)
            out[f"{prefix}teacher_AR@{pct}_{name}"] = float(mean[ti])
            out[f"{prefix}teacher_AP@{pct}_{name}"] = float(
                mean[ti + len(thresholds)])
        out[f"{prefix}gt_num_{name}"] = float(np.mean(n_gt[c]))
        out[f"{prefix}pred_num_{name}"] = float(np.mean(n_pred[c]))
    return out
