"""Event-frame rendering + box drawing for the train-time visualization
hook (a copy of `leod_tpu/utils/viz.py`; reference:
callbacks/viz_base.py:102-174, callbacks/detection.py:20-107 log
pred-vs-GT panels during training). numpy, and cv2 imported inside the
functions that draw."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def render_event_frame(ev: np.ndarray) -> np.ndarray:
    """[C, H, W] uint8 counts -> grayscale-ish RGB (white bg, events dark)
    (reference: callbacks/viz_base.py:163-174 renders ON/OFF activity)."""
    c = ev.shape[0] // 2
    pos = ev[c:].sum(0).astype(np.float32)
    neg = ev[:c].sum(0).astype(np.float32)
    img = np.full(ev.shape[-2:] + (3,), 255, np.uint8)
    img[pos > 0] = (64, 64, 200)     # ON: red-ish (BGR)
    img[neg > 0] = (200, 64, 64)     # OFF: blue-ish
    img[(pos > 0) & (neg > 0)] = (64, 160, 64)
    return img


def draw_boxes(img, boxes_xyxy, color, labels=None):
    import cv2
    for i, b in enumerate(boxes_xyxy):
        x1, y1, x2, y2 = [int(round(v)) for v in b[:4]]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 1)
        if labels is not None:
            cv2.putText(img, labels[i], (x1, max(y1 - 2, 8)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.35, color, 1)
    return img


def save_pred_vs_gt_panel(path: str, ev_hwc: np.ndarray,
                          pred_xyxy: Optional[np.ndarray],
                          gt_boxes) -> bool:
    """Render one event frame with predictions (green) and GT (black)
    and write a PNG. ev_hwc: [H, W, C] uint8. pred_xyxy rows:
    (x0,y0,x1,y1,obj,cls_conf,cls). gt_boxes: a data.labels.Boxes or
    None. Returns False (and writes nothing) if cv2 is unavailable."""
    try:
        import cv2
    except Exception:                                    # pragma: no cover
        return False
    img = render_event_frame(np.transpose(ev_hwc, (2, 0, 1)))
    if gt_boxes is not None and len(gt_boxes):
        draw_boxes(img, gt_boxes.xyxy(), (0, 0, 0))
    if pred_xyxy is not None and len(pred_xyxy):
        labels = [f"{int(p[6])}:{p[4] * p[5]:.2f}" for p in pred_xyxy]
        draw_boxes(img, pred_xyxy, (0, 200, 0), labels)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, img)
    return True
