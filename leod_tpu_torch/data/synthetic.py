"""Synthetic Gen1-format sequences (port of `leod_tpu/data/synthetic.py`).

Moving rectangles emit "events" along their edges into a stacked
histogram [T, 2*bins, H, W] uint8; labels carry microsecond timestamps
at dt=50ms per repr. Object classes: 0 = large box ("car"-like), 1 =
small box ("pedestrian"). Box sizes respect the Prophesee eval filters
(diag >= 30, side >= 10, t > 0.5s), so synthetic AP is meaningful end to
end.

`render_sequence` makes a sequence's arrays in memory with the same
random draws, in the same order, as the JAX package's
`generate_sequence`, so a seed gives the same bytes; `write_sequence`
puts them on disk in the real datasets' layout (reference:
data/genx_utils/sequence_base.py:32-48) and imports `h5py` only then.
`render_array_sequences` makes sequences that never touch the disk, and
`render_array_dataset` a train/val/test dataset of them, drawn as
`generate_dataset` draws the splits it writes.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import DatasetConfig
from .labels import BBOX_DTYPE
from .sequence import ArrayEventSequence

DT_US = 50_000  # 50 ms per event repr (stacked_histogram_dt=50)


def _draw_box_events(frame: np.ndarray, x: float, y: float, w: float,
                     h: float, rng: np.random.Generator, density: int = 25):
    """Scatter edge events of a moving box into all channels of one
    histogram frame [C, H, W] (uint8)."""
    c, fh, fw = frame.shape
    n = density
    # sample points along the 4 edges
    xs = np.concatenate([
        rng.uniform(x, x + w, n), rng.uniform(x, x + w, n),
        np.full(n, x), np.full(n, x + w)])
    ys = np.concatenate([
        np.full(n, y), np.full(n, y + h),
        rng.uniform(y, y + h, n), rng.uniform(y, y + h, n)])
    xi = np.clip(xs.astype(np.int64), 0, fw - 1)
    yi = np.clip(ys.astype(np.int64), 0, fh - 1)
    ch = rng.integers(0, c, xi.shape[0])
    np.add.at(frame, (ch, yi, xi), 40)
    # fill interior sparsely so the object has texture
    m = n * 2
    xi2 = np.clip(rng.uniform(x, x + w, m).astype(np.int64), 0, fw - 1)
    yi2 = np.clip(rng.uniform(y, y + h, m).astype(np.int64), 0, fh - 1)
    ch2 = rng.integers(0, c, m)
    np.add.at(frame, (ch2, yi2, xi2), 20)


def render_sequence(rng: np.random.Generator, num_reprs: int = 64,
                    hw: Tuple[int, int] = (240, 304), bins: int = 10,
                    num_objects: int = 2, label_every: int = 2,
                    first_label_repr: int = 11, noise_events: int = 200,
                    num_classes: int = 2, ds2: bool = False
                    ) -> Dict[str, np.ndarray]:
    """One synthetic sequence in memory: {"frames" [T, 2*bins, H, W]
    uint8, "labels" (BBOX_DTYPE), "objframe_idx_2_label_idx",
    "objframe_idx_2_repr_idx"}.

    ds2=True mimics the gen4 layout: event frames at hw/2 while labels
    stay at full resolution (the reader downsamples them by 2)."""
    h, w = hw
    c = 2 * bins
    if ds2:
        assert h % 2 == 0 and w % 2 == 0
        h, w = h // 2, w // 2     # frames stored at half resolution

    # object states: class, position, velocity, size
    objs = []
    for _ in range(num_objects):
        cls = int(rng.integers(0, num_classes))
        bw = rng.uniform(45, 80) if cls == 0 else rng.uniform(24, 34)
        bh = rng.uniform(30, 55) if cls == 0 else rng.uniform(34, 52)
        objs.append({
            "cls": cls, "w": bw, "h": bh,
            "x": rng.uniform(0, w - bw - 1), "y": rng.uniform(0, h - bh - 1),
            "vx": rng.uniform(-3, 3), "vy": rng.uniform(-2, 2),
        })

    frames = np.zeros((num_reprs, c, h, w), np.uint8)
    label_rows = []
    frame_starts = []
    objframe_idx_2_repr_idx = []
    for t in range(num_reprs):
        frame = np.zeros((c, h, w), np.int32)
        # background noise
        xi = rng.integers(0, w, noise_events)
        yi = rng.integers(0, h, noise_events)
        ch = rng.integers(0, c, noise_events)
        np.add.at(frame, (ch, yi, xi), 15)
        for o in objs:
            _draw_box_events(frame, o["x"], o["y"], o["w"], o["h"], rng)
        frames[t] = np.clip(frame, 0, 255).astype(np.uint8)

        is_labeled = (t >= first_label_repr
                      and (t - first_label_repr) % label_every == 0)
        if is_labeled:
            frame_starts.append(len(label_rows))
            objframe_idx_2_repr_idx.append(t)
            ts = (t + 1) * DT_US   # label timestamp at end of window
            scale = 2.0 if ds2 else 1.0    # labels live at full resolution
            for o in objs:
                row = np.zeros((), dtype=BBOX_DTYPE)
                row["t"] = ts
                row["x"], row["y"] = o["x"] * scale, o["y"] * scale
                row["w"], row["h"] = o["w"] * scale, o["h"] * scale
                row["class_id"] = o["cls"]
                row["class_confidence"] = 1.0
                row["objectness"] = 1.0
                label_rows.append(row)

        # advance objects AFTER drawing + labeling so GT boxes align with
        # the rendered events of this frame
        for o in objs:
            o["x"] += o["vx"]
            o["y"] += o["vy"]
            if o["x"] < 0 or o["x"] + o["w"] > w - 1:
                o["vx"] *= -1
                o["x"] = np.clip(o["x"], 0, w - 1 - o["w"])
            if o["y"] < 0 or o["y"] + o["h"] > h - 1:
                o["vy"] *= -1
                o["y"] = np.clip(o["y"], 0, h - 1 - o["h"])

    labels = (np.stack(label_rows) if label_rows
              else np.zeros((0,), BBOX_DTYPE))
    return {"frames": frames, "labels": labels,
            "objframe_idx_2_label_idx": np.asarray(frame_starts, np.int64),
            "objframe_idx_2_repr_idx": np.asarray(objframe_idx_2_repr_idx,
                                                  np.int64)}


def write_sequence(seq_dir: str, seq: Dict[str, np.ndarray],
                   ds2: bool = False,
                   ev_repr_name: str = "stacked_histogram_dt=50_nbins=10"
                   ) -> None:
    """Write `render_sequence`'s arrays as one sequence directory."""
    import h5py
    ev_dir = os.path.join(seq_dir, "event_representations_v2", ev_repr_name)
    lab_dir = os.path.join(seq_dir, "labels_v2")
    os.makedirs(ev_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    frames = seq["frames"]
    h5_name = ("event_representations_ds2_nearest.h5" if ds2
               else "event_representations.h5")
    with h5py.File(os.path.join(ev_dir, h5_name), "w") as f:
        f.create_dataset("data", data=frames, chunks=(1,) + frames.shape[1:],
                         compression="gzip", compression_opts=1)
    np.save(os.path.join(ev_dir, "objframe_idx_2_repr_idx.npy"),
            seq["objframe_idx_2_repr_idx"])
    np.savez(os.path.join(lab_dir, "labels.npz"), labels=seq["labels"],
             objframe_idx_2_label_idx=seq["objframe_idx_2_label_idx"])


def generate_sequence(seq_dir: str, rng: np.random.Generator,
                      ev_repr_name: str = "stacked_histogram_dt=50_nbins=10",
                      **kwargs) -> None:
    """Render and write one synthetic sequence directory."""
    write_sequence(seq_dir, render_sequence(rng, **kwargs),
                   ds2=kwargs.get("ds2", False), ev_repr_name=ev_repr_name)


def generate_dataset(root: str, num_train: int = 4, num_val: int = 2,
                     num_test: int = 2, seed: int = 0, **kwargs) -> str:
    """Create a tiny synthetic dataset at `root` with train/val/test splits."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", num_train), ("val", num_val),
                     ("test", num_test)):
        for i in range(n):
            generate_sequence(os.path.join(root, split, f"seq_{i:03d}"),
                              rng, **kwargs)
    return root


def render_array_sequences(cfg: DatasetConfig, num: int, seed: int = 0,
                           **kwargs) -> List[ArrayEventSequence]:
    """`num` sequences rendered in a row from one seeded generator, as
    `generate_dataset` renders a split, held in memory."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        s = render_sequence(rng, **kwargs)
        out.append(ArrayEventSequence(
            s["frames"], s["labels"], s["objframe_idx_2_label_idx"],
            s["objframe_idx_2_repr_idx"], cfg, seq_dir=f"seq_{i:03d}"))
    return out


def render_array_dataset(cfg: DatasetConfig, num_train: int = 4,
                         num_val: int = 2, num_test: int = 2, seed: int = 0,
                         **kwargs) -> Dict[str, List[ArrayEventSequence]]:
    """{"train": [...], "val": [...], "test": [...]} of array-backed
    sequences, rendered in the order and from the one seeded generator
    `generate_dataset` writes them with, so a seed gives the bytes of the
    dataset it writes (and the JAX package's generator writes), held in
    memory. The sequences are named as `generate_dataset`'s
    directories ("train/seq_000", ...)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List[ArrayEventSequence]] = {}
    for split, n in (("train", num_train), ("val", num_val),
                     ("test", num_test)):
        out[split] = []
        for i in range(n):
            s = render_sequence(rng, **kwargs)
            out[split].append(ArrayEventSequence(
                s["frames"], s["labels"], s["objframe_idx_2_label_idx"],
                s["objframe_idx_2_repr_idx"], cfg,
                seq_dir=os.path.join(split, f"seq_{i:03d}")))
    return out
