"""Event sequences made from the seed, in memory.

A sequence's event reprs are [T, 2 * bins, H, W] uint8 stacked
histograms: Poisson counts, mean `traffic["events_per_bin"]` a bin (as
`chip_smoke.py` `frames`), drawn on the card in one call as a pool of
frames that every sequence draws its reprs from, by an index map from
the seed. Labels sit on every `label_every`-th repr from `first_label`:
`boxes` boxes a frame at the dataset's full resolution, of class,
position and size drawn from the seed. The program receives these
sequences only (`ArrayEventSequence`s whose reprs come from the pool).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

DT_US = 50_000


def frame_pool(n: int, shape, mean: float, seed: int, device) -> np.ndarray:
    """n event frames [n, *shape] uint8, drawn on `device`."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    rate = torch.full((n,) + tuple(shape), mean, device=device)
    return torch.poisson(rate, generator=gen).clamp(max=255).to(
        torch.uint8).cpu().numpy()


def labels_for(rng: np.random.Generator, reprs: int, traffic: Dict,
               hw, num_classes: int):
    """(structured labels, objframe -> label index, objframe -> repr)."""
    from leod_tpu_torch.data.labels import BBOX_DTYPE
    h, w = hw
    lo_w, hi_w = traffic["box_w"]
    lo_h, hi_h = traffic["box_h"]
    rows, starts, reprs_at = [], [], []
    for t in range(traffic["first_label"], reprs, traffic["label_every"]):
        n = int(rng.integers(traffic["boxes"][0], traffic["boxes"][1] + 1))
        starts.append(len(rows))
        reprs_at.append(t)
        bw = rng.uniform(lo_w, hi_w, n) * w
        bh = rng.uniform(lo_h, hi_h, n) * h
        x = rng.uniform(0, 1, n) * (w - bw)
        y = rng.uniform(0, 1, n) * (h - bh)
        cls = rng.integers(0, num_classes, n)
        for i in range(n):
            r = np.zeros((), BBOX_DTYPE)
            r["t"] = (t + 1) * DT_US
            r["x"], r["y"], r["w"], r["h"] = x[i], y[i], bw[i], bh[i]
            r["class_id"] = cls[i]
            r["class_confidence"] = 1.0
            r["objectness"] = 1.0
            rows.append(r)
    labels = np.stack(rows) if rows else np.zeros((0,), BBOX_DTYPE)
    return labels, np.asarray(starts, np.int64), np.asarray(reprs_at, np.int64)


def sequences(config: Dict, traffic: Dict, seed: int, device) -> List:
    """traffic["sequences"] sequences of traffic["reprs"] reprs each."""
    from leod_tpu_torch.data.sequence import ArrayEventSequence

    from portbench.bench import port_config

    class PoolSequence(ArrayEventSequence):
        """A sequence whose reprs are rows of a shared pool."""

        def __init__(self, pool, idx, labels, o2l, o2r, dcfg, name):
            super().__init__(pool, labels, o2l, o2r, dcfg, seq_dir=name)
            self.idx = idx
            self.num_ev_repr = len(idx)

        def read_ev_repr(self, start: int, stop: int) -> np.ndarray:
            assert 0 <= start < stop <= self.num_ev_repr
            return self.frames[self.idx[start:stop]]

    ds = config["dataset"]
    dcfg = port_config(config, "").dataset
    h, w = ds["resolution_hw"]
    if ds["downsample_by_factor_2"]:
        fh, fw = h // 2, w // 2
    else:
        fh, fw = h, w
    shape = (config["model"]["input_channels"], fh, fw)
    pool = frame_pool(traffic["pool_frames"], shape,
                      traffic["events_per_bin"], seed, device)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(traffic["sequences"]):
        idx = rng.integers(0, len(pool), traffic["reprs"])
        lab, o2l, o2r = labels_for(rng, traffic["reprs"], traffic, (h, w),
                                   config["model"]["num_classes"])
        out.append(PoolSequence(pool, idx, lab, o2l, o2r, dcfg,
                                f"seq_{i:03d}"))
    return out
