"""Greedy-IoU constant-velocity multi-object tracker (host, numpy); a
copy of `leod_tpu/selftrain/tracker.py`, which the port does not import.

The offline tracker LEOD uses to filter pseudo labels
(reference: modules/tracking/linear.py, tracker.py, utils.py): SORT-like
but with a linear velocity model instead of a Kalman filter, confidence
q=0.9 decay on miss / weighted recovery on hit, class-aware greedy IoU
association in confidence order, boundary-clamp-aware velocity, and
"inpainting" records of predicted boxes at missed frames.

Box format throughout: [cx, cy, w, h, cls_id] (CENTER coordinates).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _xywh_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Class-aware pairwise IoU for [cx,cy,w,h,cls] rows; IoU across
    classes is zeroed (reference: utils.py:22-49)."""
    a_ = a[:, None]
    b_ = b[None, :]
    x1 = np.maximum(a_[..., 0] - a_[..., 2] / 2, b_[..., 0] - b_[..., 2] / 2)
    y1 = np.maximum(a_[..., 1] - a_[..., 3] / 2, b_[..., 1] - b_[..., 3] / 2)
    x2 = np.minimum(a_[..., 0] + a_[..., 2] / 2, b_[..., 0] + b_[..., 2] / 2)
    y2 = np.minimum(a_[..., 1] + a_[..., 3] / 2, b_[..., 1] + b_[..., 3] / 2)
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    iou = inter / (a_[..., 2] * a_[..., 3] + b_[..., 2] * b_[..., 3] - inter)
    if a.shape[-1] == 5 and b.shape[-1] == 5:
        iou[a_[..., 4] != b_[..., 4]] = 0.0
    return iou


def greedy_match(iou: np.ndarray, row_order: np.ndarray,
                 thresh: float) -> np.ndarray:
    """Greedy row-major matching: rows visited in `row_order`, each takes
    its best remaining column if IoU >= thresh (reference: utils.py:7-18).
    Returns [N, 2] (row, col) pairs."""
    iou = iou.copy()
    out = []
    for i in row_order:
        if iou[i].max() < thresh:
            continue
        j = int(np.argmax(iou[i]))
        iou[:, j] = -np.inf
        out.append((int(i), j))
    return np.asarray(out, np.int64).reshape(-1, 2)


class Tracklet:
    """One tracked object (reference: LinearBoxTracker, linear.py:10-151)."""

    def __init__(self, track_id: int, bbox: np.ndarray, bbox_idx: int,
                 is_gt: bool, img_hw: Tuple[float, float], q: float = 0.9):
        self.img_hw = img_hw
        self.bbox = bbox[:4].astype(np.float64).copy()
        self.class_id = float(bbox[4])
        self.vxvy = np.zeros(2)
        self.clamped = np.zeros(4, bool)            # t, d, l, r
        self.bbox_idx: List[int] = [bbox_idx]
        self.missed_bbox: Dict[int, np.ndarray] = {}
        self._missed_cache: Dict[int, np.ndarray] = {}
        self.is_gt = is_gt
        self.q = q
        self.conf = q
        self.all_conf = [q]
        self.id = track_id
        self.age = 0
        self.hits = 1
        self.all_hits = [1]
        self.time_since_update = 0
        self.done = False
        self.pred_bbox: Optional[np.ndarray] = None

    @property
    def area(self) -> float:
        return float(self.bbox[2] * self.bbox[3])

    def _clamped_state(self) -> np.ndarray:
        """Current box clamped into the frame; records which edges clamp
        (reference: utils.py:66-91, linear.py:54-66)."""
        h, w = self.img_hw
        cx, cy, bw, bh = self.bbox
        x1, y1, x2, y2 = cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2
        cx1, cy1 = np.clip(x1, 0, w - 1), np.clip(y1, 0, h - 1)
        cx2, cy2 = np.clip(x2, 0, w - 1), np.clip(y2, 0, h - 1)
        self.clamped = np.array([cy1 != y1, cy2 != y2, cx1 != x1, cx2 != x2])
        out = np.array([(cx1 + cx2) / 2, (cy1 + cy2) / 2,
                        cx2 - cx1, cy2 - cy1, self.class_id])
        return out

    def predict(self) -> np.ndarray:
        self.age += 1
        self.time_since_update += 1
        self._last_bbox = self.bbox.copy()
        self.bbox[:2] += self.vxvy
        self.pred_bbox = self._clamped_state()
        return self.pred_bbox.copy()

    def _velocity(self, new_bbox: np.ndarray) -> np.ndarray:
        """Clamp-aware velocity: when an edge was clamped, measure motion
        from the opposite edge (reference: linear.py:103-124)."""
        v = new_bbox[:2] - self._last_bbox[:2]
        ct, cd, cl, cr = self.clamped
        if not (ct or cd or cl or cr):
            return v
        ox1 = self._last_bbox[0] - self._last_bbox[2] / 2
        ox2 = self._last_bbox[0] + self._last_bbox[2] / 2
        oy1 = self._last_bbox[1] - self._last_bbox[3] / 2
        oy2 = self._last_bbox[1] + self._last_bbox[3] / 2
        nx1, ny1 = new_bbox[0] - new_bbox[2] / 2, new_bbox[1] - new_bbox[3] / 2
        nx2, ny2 = new_bbox[0] + new_bbox[2] / 2, new_bbox[1] + new_bbox[3] / 2
        if ct:
            v[1] = ny2 - oy2
        if cd:
            v[1] = ny1 - oy1
        if cl:
            v[0] = nx2 - ox2
        if cr:
            v[0] = nx1 - ox1
        return v

    def update(self, new_bbox: np.ndarray, bbox_idx: int, is_gt: bool):
        assert new_bbox[4] == self.class_id, "tracklet class mismatch"
        # hits is the track SPAN (age+1), NOT the matched-detection
        # count — deliberately diverging from SORT to match the
        # reference exactly (linear.py:86 sets hits = age + 1 too)
        self.hits = self.age + 1
        self.all_hits.append(self.hits)
        self.time_since_update = 0
        self.vxvy = self._velocity(new_bbox.astype(np.float64))
        self.bbox = new_bbox[:4].astype(np.float64).copy()
        self.bbox_idx.append(bbox_idx)
        self.is_gt = self.is_gt or is_gt
        # recover confidence: conf <- (w*conf + 1) / (w + 1),
        # w = q(1-q^age)/(1-q)  (reference: linear.py:52-54, 96-99)
        w = self.q * (1.0 - self.q ** self.age) / (1.0 - self.q)
        self.conf = (w * self.conf + 1.0) / (w + 1.0)
        self.all_conf.append(self.conf)
        self.missed_bbox.update(self._missed_cache)
        self._missed_cache = {}

    def miss(self, frame_idx: int, frame_has_gt: bool):
        self.conf *= self.q
        if not frame_has_gt:
            self._missed_cache[frame_idx] = self.pred_bbox.copy()

    def finish(self, done: bool = True):
        self.done = done
        self._missed_cache = {}

    def conf_at(self, bbox_idx: int) -> float:
        return self.all_conf[self.bbox_idx.index(bbox_idx)]

    def hits_at(self, bbox_idx: int) -> int:
        return self.all_hits[self.bbox_idx.index(bbox_idx)]


class LinearTracker:
    """Frame-by-frame multi-object tracker
    (reference: LinearTracker, linear.py:196-292 + Tracker, tracker.py:6-47).

    Call update(frame_idx, dets, is_gt) for EVERY frame (empty dets
    allowed); finish() before querying per-box tracklets."""

    def __init__(self, img_hw: Tuple[float, float], min_conf: float = 0.55,
                 iou_threshold: float = 0.45, q: float = 0.9):
        self.img_hw = img_hw
        self.min_conf = min_conf        # ~= 0.9**6: 6 consecutive misses
        self.iou_threshold = iou_threshold
        self.q = q
        self.tracklets: List[Tracklet] = []
        self.finished: List[Tracklet] = []
        self.bbox_idx2tracklet: Dict[int, Tracklet] = {}
        self.track_count = 0
        self.bbox_count = 0
        self.done = False

    def _retire(self, idx: int, done: bool = True):
        trk = self.tracklets.pop(idx)
        trk.finish(done=done)
        self.finished.append(trk)
        for bi in trk.bbox_idx:
            self.bbox_idx2tracklet[bi] = trk

    def update(self, frame_idx: int, dets: np.ndarray,
               is_gt: Optional[np.ndarray] = None):
        assert not self.done
        dets = np.asarray(dets, np.float64).reshape(-1, dets.shape[-1]
                                                    if len(dets) else 5)
        if len(dets) == 0 and not self.tracklets:
            return
        if is_gt is None or len(is_gt) == 0:
            is_gt = np.zeros(len(dets), bool)
        if dets.shape[1] == 4:
            dets = np.concatenate([dets, np.zeros((len(dets), 1))], axis=1)

        # predict; drop degenerate tracklets first
        for i in reversed(range(len(self.tracklets))):
            if self.tracklets[i].area <= 0:
                self._retire(i)
        preds = np.stack([t.predict() for t in self.tracklets]) \
            if self.tracklets else np.zeros((0, 5))
        order = np.argsort([-t.conf for t in self.tracklets], kind="stable")

        if len(preds) and len(dets):
            iou = _xywh_iou_matrix(preds, dets)
            matches = (greedy_match(iou, order, self.iou_threshold)
                       if iou.size and iou.max() > 0
                       else np.zeros((0, 2), np.int64))
        else:
            matches = np.zeros((0, 2), np.int64)

        matched_t = set(matches[:, 0].tolist())
        matched_d = set(matches[:, 1].tolist())
        for ti, di in matches:
            self.tracklets[ti].update(dets[di], self.bbox_count + di,
                                      bool(is_gt[di]))
        for ti, trk in enumerate(self.tracklets):
            if ti not in matched_t:
                trk.miss(frame_idx, frame_has_gt=bool(is_gt.any()))
        for di in range(len(dets)):
            if di not in matched_d:
                self.tracklets.append(Tracklet(
                    self.track_count, dets[di], self.bbox_count + di,
                    bool(is_gt[di]), self.img_hw, self.q))
                self.track_count += 1
        for i in reversed(range(len(self.tracklets))):
            if self.tracklets[i].conf < self.min_conf:
                self._retire(i)
        self.bbox_count += len(dets)

    def finish(self):
        for i in reversed(range(len(self.tracklets))):
            self._retire(i, done=False)   # unfinished: don't filter these
        self.done = True

    def tracklet_of_bbox(self, bbox_idx: int) -> Tracklet:
        assert self.done, "call finish() first"
        return self.bbox_idx2tracklet[bbox_idx]

    def new(self) -> "LinearTracker":
        return LinearTracker(self.img_hw, self.min_conf,
                             self.iou_threshold, self.q)
