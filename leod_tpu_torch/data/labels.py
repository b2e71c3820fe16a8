"""Bounding-box label containers (host side, pure numpy); a copy of
`leod_tpu/data/labels.py`, which the port does not import.

Semantics match the reference label classes
(reference: data/genx_utils/labels.py) but the design is a flat
struct-of-arrays `Boxes` value type instead of a mutable torch wrapper:
all geometric transforms return new arrays, and batching for the device
is done by padding to static shapes (the device step takes fixed shapes).

Field layout (per box, float32):
    0 t                microseconds; pseudo labels are stamped t == 0
    1 x, 2 y           TOP-LEFT corner coordinates
    3 w, 4 h           width / height
    5 class_id
    6 class_confidence
    7 objectness

The device-facing "yolox" layout is [cls_id, cx, cy, w, h, obj_conf,
cls_conf] with CENTER coordinates (reference: labels.py:543-560).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

NUM_FIELDS = 8
FIELDS = ("t", "x", "y", "w", "h", "class_id", "class_confidence", "objectness")
T, X, Y, W, H, CLS, CLS_CONF, OBJ = range(NUM_FIELDS)

# on-disk structured dtype (reference: labels.py:12-16)
BBOX_DTYPE = np.dtype({
    "names": ["t", "x", "y", "w", "h", "class_id", "class_confidence", "objectness"],
    "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<f4", "<f4"],
    "offsets": [0, 8, 12, 16, 20, 24, 28, 32], "itemsize": 40,
})

# Prophesee evaluation dtype (reference: io/box_loading.py:20-22)
PROPH_DTYPE = np.dtype({
    "names": ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"],
    "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
    "offsets": [0, 8, 12, 16, 20, 24, 28, 32], "itemsize": 40,
})


class Boxes:
    """N bounding boxes on a canvas of size `size_hw` (corner x/y format)."""

    __slots__ = ("arr", "size_hw")

    def __init__(self, arr: np.ndarray, size_hw: Tuple[float, float]):
        arr = np.asarray(arr, dtype=np.float32)
        assert arr.ndim == 2 and arr.shape[1] == NUM_FIELDS, arr.shape
        self.arr = arr
        self.size_hw = (float(size_hw[0]), float(size_hw[1]))

    # -- constructors ------------------------------------------------------
    @staticmethod
    def empty(size_hw) -> "Boxes":
        return Boxes(np.zeros((0, NUM_FIELDS), np.float32), size_hw)

    @staticmethod
    def from_structured(labels: np.ndarray, size_hw,
                        downsample_factor: Optional[float] = None) -> "Boxes":
        """From the on-disk structured array (reference: labels.py:294-310)."""
        out = np.zeros((len(labels), NUM_FIELDS), np.float32)
        names = labels.dtype.names
        for i, key in enumerate(FIELDS):
            src = key if key in names else "class_confidence"
            out[:, i] = labels[src].astype(np.float32)
        b = Boxes(out, size_hw)
        if downsample_factor is not None and downsample_factor != 1:
            b = b.scale(1.0 / downsample_factor)
        return b

    def to_structured(self) -> np.ndarray:
        out = np.zeros((len(self),), dtype=BBOX_DTYPE)
        for i, key in enumerate(FIELDS):
            out[key] = self.arr[:, i].astype(BBOX_DTYPE[key])
        return out

    def to_prophesee(self) -> np.ndarray:
        """Structured array for the Prophesee evaluator
        (reference: io/box_loading.py:47-56)."""
        out = np.zeros((len(self),), dtype=PROPH_DTYPE)
        for key in PROPH_DTYPE.names:
            if key == "track_id":
                continue
            idx = FIELDS.index(key if key != "class_confidence" else "class_confidence")
            out[key] = self.arr[:, idx].astype(PROPH_DTYPE[key])
        return out

    # -- basic accessors ---------------------------------------------------
    def __len__(self) -> int:
        return self.arr.shape[0]

    def copy(self) -> "Boxes":
        return Boxes(self.arr.copy(), self.size_hw)

    @property
    def t(self): return self.arr[:, T]
    @property
    def x(self): return self.arr[:, X]
    @property
    def y(self): return self.arr[:, Y]
    @property
    def w(self): return self.arr[:, W]
    @property
    def h(self): return self.arr[:, H]
    @property
    def class_id(self): return self.arr[:, CLS]
    @property
    def class_confidence(self): return self.arr[:, CLS_CONF]
    @property
    def objectness(self): return self.arr[:, OBJ]

    def is_pseudo(self) -> np.ndarray:
        # pseudo labels are stamped with t == 0 (reference: labels.py:168-177)
        return self.arr[:, T] == 0

    def is_gt(self) -> np.ndarray:
        return ~self.is_pseudo()

    def is_ignore(self, ignore_label: int) -> np.ndarray:
        return self.arr[:, CLS] == ignore_label

    def select(self, mask: np.ndarray) -> "Boxes":
        return Boxes(self.arr[mask], self.size_hw)

    def concat(self, other: "Boxes") -> "Boxes":
        assert self.size_hw == other.size_hw
        return Boxes(np.concatenate([self.arr, other.arr], 0), self.size_hw)

    # -- geometry ----------------------------------------------------------
    def clamped_to_frame(self) -> "Boxes":
        """Clamp corners into [0, size-1] (reference: labels.py:52-65)."""
        ht, wd = self.size_hw
        a = self.arr.copy()
        x0 = np.clip(a[:, X], 0, wd - 1)
        y0 = np.clip(a[:, Y], 0, ht - 1)
        x1 = np.clip(a[:, X] + a[:, W], 0, wd - 1)
        y1 = np.clip(a[:, Y] + a[:, H], 0, ht - 1)
        a[:, X], a[:, Y], a[:, W], a[:, H] = x0, y0, x1 - x0, y1 - y0
        return Boxes(a, self.size_hw)

    def _drop_flat(self) -> "Boxes":
        keep = (self.arr[:, W] > 0) & (self.arr[:, H] > 0)
        return Boxes(self.arr[keep], self.size_hw)

    def scale(self, mult: float) -> "Boxes":
        """Rescale canvas + boxes by `mult` (reference: labels.py:486-504)."""
        if len(self) == 0 or mult == 1:
            b = self.copy()
            b.size_hw = (self.size_hw[0] * mult, self.size_hw[1] * mult)
            return b
        new_h, new_w = self.size_hw[0] * mult, self.size_hw[1] * mult
        a = self.arr.copy()
        x1 = np.minimum((a[:, X] + a[:, W]) * mult, new_w - 1)
        y1 = np.minimum((a[:, Y] + a[:, H]) * mult, new_h - 1)
        a[:, X] *= mult
        a[:, Y] *= mult
        a[:, W] = x1 - a[:, X]
        a[:, H] = y1 - a[:, Y]
        return Boxes(a, (new_h, new_w))._drop_flat()

    def flip_lr(self) -> "Boxes":
        if len(self) == 0:
            return self.copy()
        a = self.arr.copy()
        a[:, X] = self.size_hw[1] - 1 - a[:, X] - a[:, W]
        return Boxes(a, self.size_hw)

    def rotate(self, angle_deg: float) -> "Boxes":
        """Rotate around the int-center of the canvas; new box = AABB of the
        rotated corners, clamped (reference: labels.py:327-370)."""
        if len(self) == 0:
            return self.copy()
        a = self.arr
        x0, y0 = a[:, X], a[:, Y]
        x1, y1 = x0 + a[:, W], y0 + a[:, H]
        corners_x = np.stack([x0, x1, x0, x1], 0)  # [4, N]
        corners_y = np.stack([y0, y0, y1, y1], 0)
        cx = self.size_hw[1] // 2
        cy = self.size_hw[0] // 2
        rad = math.radians(angle_deg)
        cos, sin = math.cos(rad), math.sin(rad)
        dx, dy = corners_x - cx, corners_y - cy
        rx = cos * dx + sin * dy + cx     # counter-clockwise
        ry = -sin * dx + cos * dy + cy
        ht, wd = self.size_hw
        nx0 = np.clip(rx.min(0), 0, wd - 1)
        ny0 = np.clip(ry.min(0), 0, ht - 1)
        nx1 = np.clip(rx.max(0), 0, wd - 1)
        ny1 = np.clip(ry.max(0), 0, ht - 1)
        out = a.copy()
        out[:, X], out[:, Y] = nx0, ny0
        out[:, W], out[:, H] = nx1 - nx0, ny1 - ny0
        return Boxes(out, self.size_hw)._drop_flat()

    def zoom_in(self, x0y0: Tuple[float, float], factor: float) -> "Boxes":
        """Crop window of size canvas/factor at x0y0, rescale back up
        (reference: labels.py:372-408)."""
        if len(self) == 0 or factor == 1:
            return self.copy()
        zx0, zy0 = x0y0
        h_orig, w_orig = self.size_hw
        win_h, win_w = h_orig / factor, w_orig / factor
        zx1 = min(zx0 + win_w, w_orig - 1)
        zy1 = min(zy0 + win_h, h_orig - 1)
        a = self.arr.copy()
        cx0 = np.clip(a[:, X], zx0, zx1 - 1)
        cy0 = np.clip(a[:, Y], zy0, zy1 - 1)
        cx1 = np.clip(a[:, X] + a[:, W], zx0, zx1 - 1)
        cy1 = np.clip(a[:, Y] + a[:, H], zy0, zy1 - 1)
        a[:, X], a[:, Y] = cx0 - zx0, cy0 - zy0
        a[:, W], a[:, H] = cx1 - cx0, cy1 - cy0
        cropped = Boxes(a, (win_h, win_w))._drop_flat()
        return cropped.scale(factor)

    def unzoom_in(self, x0y0: Tuple[float, float], factor: float) -> "Boxes":
        """Inverse of zoom_in (reference: labels.py:410-434)."""
        if len(self) == 0 or factor == 1:
            return self.copy()
        h_orig, w_orig = self.size_hw
        b = self.scale(1.0 / factor)
        a = b.arr.copy()
        a[:, X] += x0y0[0]
        a[:, Y] += x0y0[1]
        return Boxes(a, (h_orig, w_orig))

    def zoom_out(self, x0y0: Tuple[float, float], factor: float) -> "Boxes":
        """Shrink canvas content by `factor`, paste at x0y0
        (reference: labels.py:436-457)."""
        if len(self) == 0 or factor == 1:
            return self.copy()
        h_orig, w_orig = self.size_hw
        b = self.scale(1.0 / factor)
        a = b.arr.copy()
        a[:, X] += x0y0[0]
        a[:, Y] += x0y0[1]
        return Boxes(a, (h_orig, w_orig))

    def unzoom_out(self, x0y0: Tuple[float, float], factor: float) -> "Boxes":
        """Inverse of zoom_out (reference: labels.py:459-484)."""
        if len(self) == 0 or factor == 1:
            return self.copy()
        h_orig, w_orig = self.size_hw
        a = self.arr.copy()
        a[:, X] -= x0y0[0]
        a[:, Y] -= x0y0[1]
        b = Boxes(a, self.size_hw).scale(factor)
        b.size_hw = (h_orig, w_orig)
        return b

    # -- tensor export -----------------------------------------------------
    def to_yolox(self) -> np.ndarray:
        """[N, 7] = [cls_id, cx, cy, w, h, objectness, class_conf]
        (reference: labels.py:543-560)."""
        out = np.zeros((len(self), 7), np.float32)
        if len(self) == 0:
            return out
        a = self.arr
        out[:, 0] = a[:, CLS]
        out[:, 1] = a[:, X] + 0.5 * a[:, W]
        out[:, 2] = a[:, Y] + 0.5 * a[:, H]
        out[:, 3] = a[:, W]
        out[:, 4] = a[:, H]
        out[:, 5] = a[:, OBJ]
        out[:, 6] = a[:, CLS_CONF]
        return out

    def xyxy(self) -> np.ndarray:
        a = self.arr
        return np.stack([a[:, X], a[:, Y], a[:, X] + a[:, W], a[:, Y] + a[:, H]], -1)


def pad_yolox_batch(boxes_list: Sequence[Optional[Boxes]], max_gt: int) -> np.ndarray:
    """Stack frames' labels into [M, max_gt, 7]; zero rows are padding
    (matches the reference's `sum(...)>0` pad convention, labels.py:573-603).
    Boxes beyond `max_gt` are dropped (static-shape budget)."""
    out = np.zeros((len(boxes_list), max_gt, 7), np.float32)
    for i, b in enumerate(boxes_list):
        if b is None or len(b) == 0:
            continue
        lab = b.to_yolox()[:max_gt]
        out[i, : lab.shape[0]] = lab
    return out


class FrameLabels:
    """Frame-indexed view over one sequence's label array
    (reference: ObjectLabelFactory, labels.py:188-246)."""

    def __init__(self, boxes: Boxes, frame_to_label_idx: np.ndarray,
                 downsample_factor: Optional[float] = None):
        self.boxes = boxes.clamped_to_frame()
        self.frame_to_label_idx = np.asarray(frame_to_label_idx, np.int64)
        self.downsample_factor = downsample_factor

    @staticmethod
    def from_structured(labels: np.ndarray, frame_to_label_idx: np.ndarray,
                        size_hw, downsample_factor: Optional[float] = None
                        ) -> "FrameLabels":
        return FrameLabels(Boxes.from_structured(labels, size_hw),
                           frame_to_label_idx, downsample_factor)

    def __len__(self) -> int:
        return len(self.frame_to_label_idx)

    def __getitem__(self, item: int) -> Boxes:
        assert 0 <= item < len(self)
        lo = int(self.frame_to_label_idx[item])
        hi = (self.boxes.arr.shape[0] if item == len(self) - 1
              else int(self.frame_to_label_idx[item + 1]))
        out = Boxes(self.boxes.arr[lo:hi].copy(), self.boxes.size_hw)
        if self.downsample_factor is not None and self.downsample_factor != 1:
            out = out.scale(1.0 / self.downsample_factor)
        return out
