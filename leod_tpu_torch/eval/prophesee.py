"""Prophesee evaluation protocol (a copy of `leod_tpu/eval/prophesee.py`,
which the port does not import).

Reference semantics, re-implemented:
  * box filters applied to GT AND predictions: drop t <= 0.5s,
    diag < 30 (gen1) / 60 (gen4), side < 10 / 20, halved when the input
    was downsampled (reference: io/box_filtering.py:18-36,
    evaluation.py:22-38)
  * GT/pred streams matched per unique GT timestamp with +-50 ms
    prediction tolerance (reference: metrics/coco_eval.py:62-97)
  * COCO AP over the per-timestamp "images"
    (reference: metrics/coco_eval.py:100-140)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.labels import PROPH_DTYPE
from .coco import COCOEvaluator

LABELMAP = {"gen1": ("car", "pedestrian"),
            "gen4": ("pedestrian", "two-wheeler", "car")}
TIME_TOL_US = 50_000
SKIP_TS_US = 500_000


def filter_boxes(boxes: np.ndarray, skip_ts: int, min_box_diag: float,
                 min_box_side: float) -> np.ndarray:
    """Prophesee protocol filter (strict t >, inclusive size >=)."""
    w, h = boxes["w"], boxes["h"]
    keep = ((boxes["t"] > skip_ts)
            & (w ** 2 + h ** 2 >= min_box_diag ** 2)
            & (w >= min_box_side) & (h >= min_box_side))
    return boxes[keep]


def dataset_filter_params(camera: str, downsampled_by_2: bool):
    diag = 60 if camera == "gen4" else 30
    side = 20 if camera == "gen4" else 10
    if downsampled_by_2:
        diag //= 2
        side //= 2
    return SKIP_TS_US, diag, side


def match_times(all_ts: np.ndarray, gt: np.ndarray, dt: np.ndarray,
                tol: int = TIME_TOL_US):
    """Cut the GT/pred streams into per-timestamp windows; predictions may
    fall anywhere within +-tol of the GT time. Assumes t-sorted streams.
    Two-pointer sweep identical in effect to coco_eval.py:62-97."""
    gt_windows, dt_windows = [], []
    lo_g = hi_g = lo_d = hi_d = 0
    for ts in all_ts:
        while lo_g < len(gt) and gt["t"][lo_g] < ts:
            lo_g += 1
        hi_g = max(lo_g, hi_g)
        while hi_g < len(gt) and gt["t"][hi_g] <= ts:
            hi_g += 1
        lo, hi = ts - tol, ts + tol
        while lo_d < len(dt) and dt["t"][lo_d] < lo:
            lo_d += 1
        hi_d = max(lo_d, hi_d)
        while hi_d < len(dt) and dt["t"][hi_d] <= hi:
            hi_d += 1
        gt_windows.append(gt[lo_g:hi_g])
        dt_windows.append(dt[lo_d:hi_d])
    return gt_windows, dt_windows


def evaluate_sequences(gt_list: Sequence[np.ndarray],
                       dt_list: Sequence[np.ndarray],
                       camera: str = "gen1",
                       downsampled_by_2: bool = False,
                       num_classes: Optional[int] = None,
                       apply_filters: bool = True) -> Dict[str, float]:
    """COCO AP over PROPH_DTYPE struct-array streams (one pair per eval
    'file'; here each buffer entry is one labeled frame's boxes)."""
    classes = LABELMAP[camera]
    num_classes = num_classes or len(classes)
    if apply_filters:
        skip, diag, side = dataset_filter_params(camera, downsampled_by_2)
        gt_list = [filter_boxes(g, skip, diag, side) for g in gt_list]
        dt_list = [filter_boxes(d, skip, diag, side) for d in dt_list]

    evaluator = COCOEvaluator(num_classes)
    n_dets = 0
    for gt, dt in zip(gt_list, dt_list):
        assert np.all(np.diff(gt["t"]) >= 0) and np.all(np.diff(dt["t"]) >= 0)
        all_ts = np.unique(gt["t"])
        gt_w, dt_w = match_times(all_ts, gt, dt)
        for g, d in zip(gt_w, dt_w):
            n_dets += len(d)
            evaluator.add_image(
                gt_boxes=np.stack([g["x"], g["y"], g["w"], g["h"]], -1)
                if len(g) else np.zeros((0, 4)),
                gt_cats=g["class_id"].astype(np.int64),
                dt_boxes=np.stack([d["x"], d["y"], d["w"], d["h"]], -1)
                if len(d) else np.zeros((0, 4)),
                dt_cats=d["class_id"].astype(np.int64),
                dt_scores=d["class_confidence"].astype(np.float64))
    if n_dets == 0:
        return {k: 0.0 for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")}
    return evaluator.summarize()


class PropheseeEvaluator:
    """Accumulation buffer across eval steps
    (reference: evaluator.py:25-110). One entry per labeled frame."""

    def __init__(self, dataset: str, downsample_by_2: bool):
        assert dataset in LABELMAP
        self.dataset = dataset
        self.downsample_by_2 = downsample_by_2
        self.labels: List[np.ndarray] = []
        self.predictions: List[np.ndarray] = []

    def add_labels(self, labels: Sequence[np.ndarray]):
        self.labels.extend(labels)

    def add_predictions(self, preds: Sequence[np.ndarray]):
        self.predictions.extend(preds)

    def has_data(self) -> bool:
        return len(self.labels) > 0

    def reset(self):
        self.labels, self.predictions = [], []

    def merge(self, *others: "PropheseeEvaluator") -> "PropheseeEvaluator":
        """Fold other shards' buffers into this one (the reference reduces
        metrics across ranks with sync_dist; here the raw buffers merge
        before a single COCO eval, which is exact rather than averaged)."""
        for o in others:
            assert o.dataset == self.dataset
            self.labels.extend(o.labels)
            self.predictions.extend(o.predictions)
        return self

    def evaluate(self) -> Optional[Dict[str, float]]:
        if not self.has_data():
            return None
        assert len(self.labels) == len(self.predictions)
        metrics = evaluate_sequences(self.labels, self.predictions,
                                     camera=self.dataset,
                                     downsampled_by_2=self.downsample_by_2)
        # per-class breakdown (reference: evaluator.py:92-104)
        for cls_id, cls_name in enumerate(LABELMAP[self.dataset]):
            lbls = [l[l["class_id"] == cls_id] for l in self.labels]
            prds = [p[p["class_id"] == cls_id] for p in self.predictions]
            cm = evaluate_sequences(lbls, prds, camera=self.dataset,
                                    downsampled_by_2=self.downsample_by_2)
            metrics.update({f"{k}_{cls_name}": v for k, v in cm.items()})
        return metrics


def boxes_to_prophesee(labels_boxes, pred_xyxy: Optional[np.ndarray],
                       pred_t: Optional[int] = None) -> tuple:
    """Bridge one frame's (GT Boxes, postprocessed dets) to struct arrays.
    pred_xyxy rows: (x0, y0, x1, y1, obj_conf, cls_conf, cls_id); prediction
    timestamps inherit the frame's GT time (reference: io/box_loading.py:58-107).
    """
    gt = labels_boxes.to_prophesee()
    times = np.unique(gt["t"])
    assert times.size == 1, "all GT boxes of a frame must share a timestamp"
    t = int(times[0]) if pred_t is None else pred_t
    n = 0 if pred_xyxy is None else len(pred_xyxy)
    dt = np.zeros((n,), PROPH_DTYPE)
    if n:
        dt["t"] = t
        dt["x"] = pred_xyxy[:, 0]
        dt["y"] = pred_xyxy[:, 1]
        dt["w"] = pred_xyxy[:, 2] - pred_xyxy[:, 0]
        dt["h"] = pred_xyxy[:, 3] - pred_xyxy[:, 1]
        dt["class_id"] = pred_xyxy[:, 6].astype(np.uint32)
        dt["class_confidence"] = pred_xyxy[:, 5]
    return gt, dt
