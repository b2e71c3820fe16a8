"""Sequence-consistent spatial augmentation (host side, numpy); a copy of
`leod_tpu/data/augment.py`, which the port does not import.

Covers the reference's RandomSpatialAugmentorGenX
(reference: data/utils/augmentor.py:125-562): h-flip, rotation,
zoom-in (cropped around a random GT box so labels survive), zoom-out,
and the t-flip flag (applied at the sequence level since it inverts
window order). Parameters are randomized once per event sequence and
applied identically to every window of that sequence.

Frames are [C, H, W] (or [T, C, H, W]) numpy arrays; labels are
`Boxes`. Nearest resize uses the 'nearest-exact' index rule
(src = floor((dst + 0.5) * in / out)) to match torch interpolate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from ..config import AugmentConfig
from .labels import Boxes


def resize_nearest(frames: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-exact resize over the last two axes."""
    h_in, w_in = frames.shape[-2:]
    h_out, w_out = out_hw
    yi = np.minimum(((np.arange(h_out) + 0.5) * (h_in / h_out)).astype(np.int64),
                    h_in - 1)
    xi = np.minimum(((np.arange(w_out) + 0.5) * (w_in / w_out)).astype(np.int64),
                    w_in - 1)
    return frames[..., yi[:, None], xi[None, :]]


def rotate_frames_nearest(frames: np.ndarray, angle_deg: float) -> np.ndarray:
    """Counter-clockwise rotation about the canvas pixel-center
    ((w-1)/2, (h-1)/2), nearest sampling (round-half-even), zero fill —
    torchvision rotate(NEAREST) tensor semantics, verified differentially
    (tests/test_augment_ref.py, on the JAX package's copy). NOTE the
    reference's LABEL rotation pivots about the int-center
    (labels.py:341-342), half a pixel away — that
    frame/label inconsistency is the reference's own; boxes here keep the
    reference's label convention (data/labels.py Boxes.rotate)."""
    h, w = frames.shape[-2:]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rad = math.radians(angle_deg)
    cos, sin = math.cos(rad), math.sin(rad)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dx, dy = xx - cx, yy - cy
    # inverse map: rotate output coords by -angle to find source pixel
    sx = np.round(cos * dx - sin * dy + cx).astype(np.int64)
    sy = np.round(sin * dx + cos * dy + cy).astype(np.int64)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    sx = np.clip(sx, 0, w - 1)
    sy = np.clip(sy, 0, h - 1)
    out = frames[..., sy, sx]
    return np.where(valid, out, 0).astype(frames.dtype)


@dataclass
class AugmentParams:
    """Randomized-once-per-sequence augmentation state
    (reference: AugmentationState, augmentor.py:60-122)."""
    hflip: bool = False
    tflip: bool = False
    rotate_deg: float = 0.0
    zoom_out: Optional[Tuple[int, int, float]] = None   # (x0, y0, factor)
    zoom_in_factor: float = 1.0                         # window picked per use
    zoom_in_xy: Optional[Tuple[int, int]] = None


class SpatialAugmentor:
    """Randomize once per sequence; apply to each window's frames+labels."""

    def __init__(self, hw: Tuple[int, int], cfg: AugmentConfig,
                 rng: Optional[np.random.Generator] = None,
                 zoom_in_random_fallback: bool = False):
        self.hw = hw
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()
        self.params = AugmentParams()
        # with no GT in the window, zoom-in normally deactivates (the crop
        # is anchored on a random GT box); SSOD strong views instead crop
        # a uniformly random window so unlabeled data still gets the
        # augmentation (the whole point of weak/strong SSOD)
        self.zoom_in_random_fallback = zoom_in_random_fallback
        # exact transform applied by the last apply() call (per-window
        # zoom-in crop origin included) — what a teacher-prediction
        # mapper must replay, see weak_to_strong_boxes
        self.last_applied = AugmentParams()

    def randomize(self):
        c, rng = self.cfg, self.rng
        p = AugmentParams()
        p.hflip = rng.random() < c.prob_hflip
        p.tflip = rng.random() < c.prob_tflip
        if rng.random() < c.rotate_prob:
            sign = 1.0 if rng.random() < 0.5 else -1.0
            p.rotate_deg = sign * rng.uniform(c.rotate_min_deg, c.rotate_max_deg)
        z = c.zoom
        total_w = z.zoom_in_weight + z.zoom_out_weight
        do_zoom = rng.random() < z.prob and total_w > 0
        if do_zoom:
            zoom_in = rng.random() < (z.zoom_in_weight / total_w)
            if zoom_in:
                p.zoom_in_factor = rng.uniform(z.zoom_in_min, z.zoom_in_max)
            else:
                f = rng.uniform(z.zoom_out_min, z.zoom_out_max)
                if f > 1:
                    h, w = self.hw
                    win_h, win_w = int(h / f), int(w / f)
                    x0 = int(rng.uniform(0, w - win_w))
                    y0 = int(rng.uniform(0, h - win_h))
                    p.zoom_out = (x0, y0, f)
        self.params = p

    # -- per-window application ----------------------------------------------
    def _pick_zoom_in_window(self, labels: List[Optional[Boxes]],
                             factor: float) -> Optional[Tuple[int, int]]:
        """Window top-left sampled so a random box of the most recent
        labeled frame stays inside (reference: augmentor.py:284-308)."""
        h, w = self.hw
        win_h, win_w = int(h / factor), int(w / factor)
        latest = None
        for lab in reversed(labels):
            if lab is not None and len(lab) > 0:
                latest = lab
                break
        if latest is None:
            if not self.zoom_in_random_fallback:
                return None
            return (int(self.rng.uniform(0, w - win_w)),
                    int(self.rng.uniform(0, h - win_h)))
        i = int(self.rng.integers(0, len(latest)))
        bx0, by0 = float(latest.x[i]), float(latest.y[i])
        bx1 = min(bx0 + float(latest.w[i]), w - 1)
        by1 = min(by0 + float(latest.h[i]), h - 1)
        # x0 range keeping the box inside [x0, x0+win]
        x_lo, x_hi = max(bx1 - win_w, 0), min(bx0, w - win_w)
        y_lo, y_hi = max(by1 - win_h, 0), min(by0, h - win_h)
        x0 = int(self.rng.uniform(x_lo, max(x_hi, x_lo)))
        y0 = int(self.rng.uniform(y_lo, max(y_hi, y_lo)))
        return (x0, y0)

    def apply(self, sample: dict) -> dict:
        """Transform one window sample dict in place-ish (frames+labels).
        t-flip is NOT applied here — callers switch the sequence into
        time-flip mode (reference: sequence_streaming.py:308-318)."""
        p = self.params
        ev = sample["ev_repr"]                   # [T, C, H, W]
        labels = list(sample["labels"])
        skipped = list(sample["skipped_labels"])
        h, w = self.hw

        def map_labels(fn):
            nonlocal labels, skipped
            labels = [None if l is None else fn(l) for l in labels]
            skipped = [None if l is None else fn(l) for l in skipped]
            labels = [None if (l is not None and len(l) == 0) else l
                      for l in labels]
            skipped = [None if (l is not None and len(l) == 0) else l
                       for l in skipped]

        applied = replace(p, zoom_in_xy=None)
        # reference application order: hflip -> rotate -> zoom
        # (augmentor.py:466-474; weak2strong replays the same order,
        # ssod.py:391-404)
        if p.hflip:
            ev = ev[..., ::-1].copy()
            map_labels(lambda l: l.flip_lr())
        if p.rotate_deg != 0.0:
            ev = rotate_frames_nearest(ev, p.rotate_deg)
            map_labels(lambda l: l.rotate(p.rotate_deg))
        if p.zoom_in_factor > 1.0:
            xy = self._pick_zoom_in_window(labels, p.zoom_in_factor)
            applied.zoom_in_xy = xy
            if xy is None:
                applied.zoom_in_factor = 1.0
            else:
                x0, y0 = xy
                f = p.zoom_in_factor
                win_h, win_w = int(h / f), int(w / f)
                crop = ev[..., y0:y0 + win_h, x0:x0 + win_w]
                ev = resize_nearest(crop, (h, w))
                map_labels(lambda l: l.zoom_in((x0, y0), f))
        elif p.zoom_out is not None:
            x0, y0, f = p.zoom_out
            win_h, win_w = int(h / f), int(w / f)
            small = resize_nearest(ev, (win_h, win_w))
            out = np.zeros_like(ev)
            out[..., y0:y0 + win_h, x0:x0 + win_w] = small
            ev = out
            map_labels(lambda l: l.zoom_out((x0, y0), f))

        out = dict(sample)
        out["ev_repr"] = ev
        out["labels"] = labels
        out["skipped_labels"] = skipped
        self.last_applied = applied
        return out


class SSODAugmentor:
    """Weak + strong views of the same window for online SSOD training
    (reference: data/utils/ssod_augmentor.py:21-61 — shipped but never
    wired there; live in `selftrain/online.py`).

    Weak = h-flip only at p=0.5; strong = the full augment config.
    Both views share the base timeline (no t-flip: it reorders windows
    at the sequence level and would desynchronize the pair)."""

    def __init__(self, hw: Tuple[int, int], cfg: AugmentConfig,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        weak_cfg = replace(cfg, prob_hflip=0.5, prob_tflip=0.0,
                           rotate_prob=0.0,
                           zoom=replace(cfg.zoom, prob=0.0))
        strong_cfg = replace(cfg, prob_tflip=0.0)
        self.weak = SpatialAugmentor(hw, weak_cfg, rng)
        self.strong = SpatialAugmentor(hw, strong_cfg, rng,
                                       zoom_in_random_fallback=True)

    def randomize(self):
        self.weak.randomize()
        self.strong.randomize()

    def __call__(self, sample: dict) -> Tuple[dict, dict]:
        """-> (weak view, strong view). apply() never mutates the input
        arrays/Boxes, so the two views can share the base sample."""
        return self.weak.apply(sample), self.strong.apply(sample)


def weak_to_strong_boxes(boxes: Boxes, weak: AugmentParams,
                         strong: AugmentParams) -> Boxes:
    """Map boxes living in the WEAK view (teacher predictions) into the
    STRONG view's coordinate space (student supervision): undo the weak
    h-flip (its own inverse), then replay the strong transform in
    apply()'s order — h-flip, rotate, zoom (reference semantics:
    modules/utils/ssod.py:353-426 and augmentor.py:466-474). `strong`
    must be the `last_applied` record of the strong view's apply() call
    so the per-window zoom-in crop origin is the one actually used."""
    out = boxes
    if weak.hflip:
        out = out.flip_lr()
    if strong.hflip:
        out = out.flip_lr()
    if strong.rotate_deg != 0.0:
        out = out.rotate(strong.rotate_deg)
    if strong.zoom_in_factor > 1.0 and strong.zoom_in_xy is not None:
        out = out.zoom_in(strong.zoom_in_xy, strong.zoom_in_factor)
    elif strong.zoom_out is not None:
        x0, y0, f = strong.zoom_out
        out = out.zoom_out((x0, y0), f)
    return out
