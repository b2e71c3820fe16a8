"""COCO-style detection AP in numpy (a copy of `leod_tpu/eval/coco.py`):
the per-image matching runs in the C++ of `native/host_ops.cpp` where the
host library builds, and else in numpy with the same results.

Drop-in replacement for the pycocotools/COCOeval_opt dependency
(reference: utils/evaluation/prophesee/metrics/coco_eval.py:16-29) since
pycocotools is not available in this environment. Implements the
standard COCOeval 'bbox' protocol:

  * IoU thresholds 0.50:0.05:0.95, 101 recall points
  * greedy score-descending matching, ignore-aware (area-range GTs)
  * per-(category, area, maxDet) accumulation with precision envelope

Inputs are per-image lists of dict-like boxes in xywh (top-left) format.
Verified against hand-computed cases in tests/test_coco.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[D, G] IoU for xywh boxes."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0:1], dt[:, 1:2]
    dx1, dy1 = dx0 + dt[:, 2:3], dy0 + dt[:, 3:4]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gx0 + gt[:, 2], gy0 + gt[:, 3]
    ix = np.maximum(np.minimum(dx1, gx1) - np.maximum(dx0, gx0), 0)
    iy = np.maximum(np.minimum(dy1, gy1) - np.maximum(dy0, gy0), 0)
    inter = ix * iy
    area_d = (dt[:, 2] * dt[:, 3])[:, None]
    area_g = gt[:, 2] * gt[:, 3]
    return inter / np.maximum(area_d + area_g - inter, 1e-12)


def _evaluate_image_all_areas(gt_boxes: np.ndarray, gt_ignore: np.ndarray,
                              dt_boxes: np.ndarray, dt_scores: np.ndarray,
                              max_det: int):
    """Match one image/category for EVERY area range with the IoU matrix
    computed once (pycocotools computes IoUs once per (image, cat) the
    same way). Returns (dt_matched [A,T,D] bool, dt_ig [A,T,D] bool,
    npig [A], dt_scores [D]) with detections score-sorted desc, capped."""
    d_ord = np.argsort(-dt_scores, kind="stable")[:max_det]
    dt_boxes, dt_scores = dt_boxes[d_ord], dt_scores[d_ord]
    areas = np.array(list(AREA_RANGES.values()), np.float64)
    A, T, D, G = len(areas), len(IOU_THRS), len(dt_boxes), len(gt_boxes)

    if G == 0:
        # nothing to match: every det is an FP, ignored when out of range
        dt_area = dt_boxes[:, 2] * dt_boxes[:, 3] if D else np.zeros(0)
        out = (dt_area[None, :] < areas[:, :1]) | (dt_area[None, :]
                                                   > areas[:, 1:])
        return (np.zeros((A, T, D), bool),
                np.broadcast_to(out[:, None, :], (A, T, D)),
                np.zeros((A,), np.int64), dt_scores)
    if D == 0:
        gt_area = gt_boxes[:, 2] * gt_boxes[:, 3]
        gt_ig = (gt_ignore[None, :] | (gt_area[None, :] < areas[:, :1])
                 | (gt_area[None, :] > areas[:, 1:]))
        return (np.zeros((A, T, 0), bool), np.zeros((A, T, 0), bool),
                (~gt_ig).sum(axis=1).astype(np.int64), dt_scores)

    if D and G:
        from ..native import coco_eval_image
        native = coco_eval_image(dt_boxes, gt_boxes, gt_ignore, IOU_THRS,
                                 areas)
        if native is not None:
            dtm, dt_ig, npig = native
            return dtm, dt_ig, npig, dt_scores

    ious = _iou_xywh(dt_boxes, gt_boxes)
    gt_area = gt_boxes[:, 2] * gt_boxes[:, 3] if G else np.zeros(0)
    dt_area = dt_boxes[:, 2] * dt_boxes[:, 3] if D else np.zeros(0)
    dtm = np.zeros((A, T, D), bool)
    dt_ig = np.zeros((A, T, D), bool)
    npig = np.zeros((A,), np.int64)
    for ai, (a0, a1) in enumerate(areas):
        gt_ig = gt_ignore | (gt_area < a0) | (gt_area > a1)
        npig[ai] = int((~gt_ig).sum())
        # gts iterated non-ignore first, stable (pycocotools gtind sort)
        g_ord = np.argsort(gt_ig, kind="stable")
        out_of_rng = (dt_area < a0) | (dt_area > a1)
        for ti, t in enumerate(IOU_THRS):
            gtm = np.zeros((G,), bool)
            for d in range(D):
                best_iou = min(t, 1 - 1e-10)
                m = -1
                for g in g_ord:
                    if gtm[g]:
                        continue
                    # once we have a real match and hit the ignore
                    # region, stop (pycocotools semantics)
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    m = g
                if m == -1:
                    dt_ig[ai, ti, d] = out_of_rng[d]
                    continue
                dtm[ai, ti, d] = True
                dt_ig[ai, ti, d] = gt_ig[m]
                gtm[m] = True
    return dtm, dt_ig, npig, dt_scores


class COCOEvaluator:
    """Accumulates per-image GT/detections and computes COCO AP stats."""

    def __init__(self, num_categories: int):
        self.num_categories = num_categories
        # per (cat) lists of per-image eval results, keyed later by area
        self._images: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]] = []

    def add_image(self, gt_boxes: np.ndarray, gt_cats: np.ndarray,
                  dt_boxes: np.ndarray, dt_cats: np.ndarray,
                  dt_scores: np.ndarray,
                  gt_ignore: Optional[np.ndarray] = None):
        """Boxes in xywh. Categories are 0-based ints."""
        gt_ignore = (np.zeros(len(gt_boxes), bool) if gt_ignore is None
                     else gt_ignore)
        self._images.append((np.asarray(gt_boxes, np.float64).reshape(-1, 4),
                             np.asarray(gt_cats, np.int64),
                             np.asarray(dt_boxes, np.float64).reshape(-1, 4),
                             np.asarray(dt_cats, np.int64),
                             np.asarray(dt_scores, np.float64),
                             ) + (np.asarray(gt_ignore, bool),))

    def _compute_precision(self) -> np.ndarray:
        """Precision tensor [T, R, K, A] (-1 where no GT in range)."""
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = self.num_categories
        A = len(AREA_RANGES)
        precision = -np.ones((T, R, K, A))

        for k in range(K):
            per_area = [[] for _ in range(A)]          # (dtm, dt_ig, scores)
            npig_tot = np.zeros((A,), np.int64)
            for (gtb, gtc, dtb, dtc, dts, gti) in self._images:
                g_sel = gtc == k
                d_sel = dtc == k
                dtm, dt_ig, npig, scores = _evaluate_image_all_areas(
                    gtb[g_sel], gti[g_sel], dtb[d_sel], dts[d_sel], MAX_DETS)
                npig_tot += npig
                for ai in range(A):
                    per_area[ai].append((dtm[ai], dt_ig[ai], scores))
            for ai in range(A):
                npig = int(npig_tot[ai])
                if npig == 0:
                    continue
                scores = np.concatenate([r[2] for r in per_area[ai]])
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate(
                    [r[0] for r in per_area[ai]], axis=1)[:, order]
                dt_ig = np.concatenate(
                    [r[1] for r in per_area[ai]], axis=1)[:, order]
                tps = dtm & ~dt_ig
                fps = ~dtm & ~dt_ig
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    # precision envelope (monotone from the right)
                    pr = np.maximum.accumulate(pr[::-1])[::-1]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    valid = inds < len(pr)
                    q[valid] = pr[inds[valid]]
                    precision[ti, :, k, ai] = q
        return precision

    @staticmethod
    def _metrics(precision: np.ndarray) -> Dict[str, float]:
        names = list(AREA_RANGES)

        def _ap(t_slice=slice(None), area_idx=0):
            # -1 when no GT falls in the range (pycocotools convention)
            p = precision[t_slice, :, :, area_idx]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        return {
            "AP": _ap(),
            "AP_50": _ap(slice(0, 1)),
            "AP_75": _ap(slice(5, 6)),
            "AP_S": _ap(area_idx=names.index("small")),
            "AP_M": _ap(area_idx=names.index("medium")),
            "AP_L": _ap(area_idx=names.index("large")),
        }

    def summarize(self) -> Dict[str, float]:
        return self._metrics(self._compute_precision())
