"""Raw Prophesee recording -> pre-voxelized dataset importer (port of
`leod_tpu/data/import_raw.py:35-180`).

Voxelizes on the card by default (`ops/voxel.stacked_histogram_batch`, an
`index_add_` into int32 counts), or on the CPU when asked, so a raw
Gen1/1Mpx download becomes a training-ready dataset with one command:

    python -m leod_tpu_torch.cli.import_raw --raw-dir <downloads> --out <root> \\
        --split train [--ds2] [--class-map 0:0,1:1,2:2]

Each recording is `<name>.dat` or `<name>.npy` events with labels at
`<name>_bbox.npy` (the Prophesee release naming). Output is the JAX
package's layout, byte for byte: `event_representations_v2/<repr>/...h5`
(uint8 [T, 2*bins, H, W]) + `labels_v2/labels.npz` + the objframe-index
map, the layout `EventSequence` reads. With `frames=` (a frame store, as
`data/synthetic.py` `render_dataset_frames` returns, for a machine
without `h5py`) the label and index files go to disk and each
recording's frames into the store under `frame_key(seq_dir)`, for
`open_split_sequences(frames=)` and the CLIs' `frames=`.
"""
from __future__ import annotations

import os
from typing import Dict, MutableMapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.voxel import stacked_histogram_batch
from .labels import BBOX_DTYPE
from .psee import RawEventReader, load_boxes
from .sequence import frame_key

DT_US = 50_000          # 50 ms per representation window
_PAD_QUANTUM = 65_536   # event-count padding unit (bounds allocations)


def _chunk_histograms(windows, bins: int, height: int, width: int,
                      ds2: bool, device="cuda") -> np.ndarray:
    """Voxelize a list of per-window event arrays on `device`.

    Windows are padded to a shared budget, rounded up to _PAD_QUANTUM.
    ds2 takes every second row/col of the full-res histogram — the
    `_ds2_nearest` layout's nearest-neighbor downsample."""
    budget = max(max((len(w) for w in windows), default=1), 1)
    budget = ((budget + _PAD_QUANTUM - 1) // _PAD_QUANTUM) * _PAD_QUANTUM
    n = len(windows)
    x = np.zeros((n, budget), np.int32)
    y = np.zeros((n, budget), np.int32)
    p = np.zeros((n, budget), np.int32)
    t = np.zeros((n, budget), np.int32)
    valid = np.zeros((n, budget), bool)
    for i, w in enumerate(windows):
        k = len(w)
        x[i, :k] = w["x"]
        y[i, :k] = w["y"]
        p[i, :k] = w["p"]
        t[i, :k] = w["t"].astype(np.int64) - (int(w["t"][0]) if k else 0)
        valid[i, :k] = True
    dev = resolve_device(device)
    hist = stacked_histogram_batch(
        *(torch.from_numpy(a).to(dev) for a in (x, y, p, t, valid)),
        bins=bins, height=height, width=width)
    if ds2:
        hist = hist[:, :, ::2, ::2]
    return hist.cpu().numpy()


def _parse_class_map(spec: Optional[str]) -> Optional[Dict[int, int]]:
    """'0:0,1:1,2:2' -> {0: 0, 1: 1, 2: 2}; unmapped raw classes drop."""
    if not spec:
        return None
    out = {}
    for pair in spec.split(","):
        src, dst = pair.split(":")
        out[int(src)] = int(dst)
    return out


def _labels(labels_path: Optional[str], num_reprs: int, dt_us: int,
            class_map: Optional[Dict[int, int]]):
    """(labels, objframe -> first label index, objframe -> repr index).

    Boxes group by WINDOW INDEX into labeled frames — window k covers
    (k*dt, (k+1)*dt] so a label at t lands on repr ceil(t/dt)-1. All
    timestamps that fall in one window form ONE objframe: EventSequence's
    repr_idx -> objframe map is a dict, so one objframe per raw timestamp
    would shadow all but the last group in each window."""
    labels = np.zeros((0,), BBOX_DTYPE)
    frame_starts = np.zeros((0,), np.int64)
    repr_idx = np.zeros((0,), np.int64)
    if labels_path is None:
        return labels, frame_starts, repr_idx
    boxes = load_boxes(labels_path)
    boxes = boxes[np.argsort(boxes["t"], kind="stable")]
    if class_map is not None:
        keep = np.isin(boxes["class_id"], list(class_map))
        boxes = boxes[keep]
        remap = np.zeros(max(class_map) + 1, np.uint32)
        for src, dst in class_map.items():
            remap[src] = dst
        boxes["class_id"] = remap[boxes["class_id"]]
    if len(boxes):
        ts = boxes["t"].astype(np.int64)
        widx = np.clip((ts + dt_us - 1) // dt_us - 1, 0, num_reprs - 1)
        # boxes are t-sorted so widx is non-decreasing: one pass finds
        # the window-group boundaries
        frame_starts = np.flatnonzero(
            np.r_[True, widx[1:] != widx[:-1]]).astype(np.int64)
        repr_idx = widx[frame_starts]
        labels = np.zeros(len(boxes), BBOX_DTYPE)
        for name in ("t", "x", "y", "w", "h", "class_id",
                     "class_confidence"):
            labels[name] = boxes[name]
        labels["objectness"] = 1.0
        # t == 0 is the framework-wide PSEUDO-label stamp (labels.py
        # is_pseudo); a raw GT stream that starts at recording time 0
        # must not masquerade as pseudo: bump it by 1 us
        labels["t"] = np.maximum(labels["t"], 1)
    return labels, frame_starts, repr_idx


def import_recording(events_path: str, labels_path: Optional[str],
                     seq_dir: str, height: int, width: int,
                     bins: int = 10, dt_us: int = DT_US,
                     ds2: bool = False, batch: int = 16,
                     class_map: Optional[Dict[int, int]] = None,
                     ev_repr_name: Optional[str] = None,
                     frames: Optional[MutableMapping[str, np.ndarray]] = None,
                     device="cuda") -> Tuple[int, int]:
    """Voxelize one raw recording into `seq_dir` on `device` (the card
    unless the caller asks for the CPU). Returns (num_reprs,
    num_labeled_frames). The repr directory name is derived from the
    actual dt/bins so DatasetConfig.ev_repr_name can never silently
    mismatch the written channel count. With `frames`, the event frames
    [T, 2*bins, H, W] go into it under `frame_key(seq_dir)` instead of an
    h5 file."""
    if ev_repr_name is None:
        ev_repr_name = f"stacked_histogram_dt={dt_us // 1000}_nbins={bins}"
    reader = RawEventReader(events_path)
    if None not in reader.size:
        # only trust a COMPLETE header: a .dat carrying Height but not
        # Width (or vice versa) must not half-override the user dims
        height, width = reader.size
    if ds2:
        assert height % 2 == 0 and width % 2 == 0
    num_reprs = max(1, int(np.ceil((reader.total_time() + 1) / dt_us)))

    out_h, out_w = (height // 2, width // 2) if ds2 else (height, width)
    ev_dir = os.path.join(seq_dir, "event_representations_v2", ev_repr_name)
    os.makedirs(ev_dir, exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "labels_v2"), exist_ok=True)
    c = 2 * bins
    shape = (num_reprs, c, out_h, out_w)

    def chunks():
        done = 0
        while done < num_reprs:
            n = min(batch, num_reprs - done)
            windows = [reader.load_delta_t(dt_us) for _ in range(n)]
            yield done, _chunk_histograms(windows, bins, height, width, ds2,
                                          device)
            done += n

    if frames is not None:
        data = np.zeros(shape, np.uint8)
        for i, hist in chunks():
            data[i:i + len(hist)] = hist
        frames[frame_key(seq_dir)] = data
    else:
        import h5py
        suffix = "_ds2_nearest" if ds2 else ""
        h5_path = os.path.join(ev_dir, f"event_representations{suffix}.h5")
        with h5py.File(h5_path, "w") as f:
            dset = f.create_dataset("data", shape=shape, dtype=np.uint8,
                                    chunks=(1,) + shape[1:],
                                    compression="gzip", compression_opts=1)
            for i, hist in chunks():
                dset[i:i + len(hist)] = hist

    labels, frame_starts, repr_idx = _labels(labels_path, num_reprs, dt_us,
                                             class_map)
    np.savez(os.path.join(seq_dir, "labels_v2", "labels.npz"), labels=labels,
             objframe_idx_2_label_idx=frame_starts)
    np.save(os.path.join(ev_dir, "objframe_idx_2_repr_idx.npy"), repr_idx)
    return num_reprs, len(repr_idx)


def import_split(raw_dir: str, out_root: str, split: str, height: int,
                 width: int, **kwargs) -> int:
    """Import every recording under `raw_dir` into `<out_root>/<split>/`
    (`import_recording`'s keyword arguments pass through). Returns the
    number of sequences imported."""
    names = sorted({
        os.path.splitext(f)[0] for f in os.listdir(raw_dir)
        if f.endswith((".dat", ".npy")) and not f.endswith("_bbox.npy")})
    count = 0
    for name in names:
        for ext in (".dat", ".npy"):
            events = os.path.join(raw_dir, name + ext)
            if os.path.exists(events):
                break
        labels = os.path.join(raw_dir, name + "_bbox.npy")
        import_recording(events, labels if os.path.exists(labels) else None,
                         os.path.join(out_root, split, name),
                         height, width, **kwargs)
        count += 1
    return count
