"""Event-sequence reading: one directory in the Gen1/Gen4 on-disk format
(a copy of `leod_tpu/data/sequence.py`, plus `ArrayEventSequence`).

Disk layout (documented in reference: data/genx_utils/sequence_base.py:32-48):

    <seq_dir>/
      event_representations_v2/<ev_repr_name>/
        event_representations[_ds2_nearest].h5   # 'data': [T, C, H, W] uint8
        objframe_idx_2_repr_idx.npy              # labeled frame -> repr idx
      labels_v2/labels.npz                       # 'labels' (BBOX_DTYPE),
                                                 # 'objframe_idx_2_label_idx'

This module covers sequence opening, h5 range reads, WSOD label
subsampling, window cutting for streaming iteration, label-guaranteed
stream parts and random-access windows for training, and time-flip
(reference: sequence_base.py, sequence_streaming.py, sequence_rnd.py)
as plain-numpy host code. `h5py` is imported only where an h5 file is opened, and
`ArrayEventSequence` serves the same sequence from arrays in memory
(see its docstring).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import DatasetConfig
from .labels import Boxes, FrameLabels


def ev_repr_dir(seq_dir: str, ev_repr_name: str) -> str:
    return os.path.join(seq_dir, "event_representations_v2", ev_repr_name)


def ev_h5_path(seq_dir: str, ev_repr_name: str, downsample_by_2: bool) -> str:
    suffix = "_ds2_nearest" if downsample_by_2 else ""
    return os.path.join(ev_repr_dir(seq_dir, ev_repr_name),
                        f"event_representations{suffix}.h5")


def labels_npz_path(seq_dir: str) -> str:
    return os.path.join(seq_dir, "labels_v2", "labels.npz")


def list_sequence_dirs(dataset_path: str, split: str) -> List[str]:
    split_dir = os.path.join(dataset_path, split)
    if not os.path.isdir(split_dir):
        return []
    return sorted(os.path.join(split_dir, d) for d in os.listdir(split_dir)
                  if os.path.isdir(os.path.join(split_dir, d)))


class EventSequence:
    """One event sequence: lazily-opened h5 + frame-indexed labels.

    WSOD label subsampling keeps every round(1/ratio)-th labeled frame
    (reference: sequence_base.py:116-145); skipped labels stay loadable
    for pseudo-label quality evaluation.
    """

    def __init__(self, seq_dir: str, cfg: DatasetConfig,
                 keep_objframe_idx: Optional[Sequence[int]] = None,
                 label_ratio: Optional[float] = None):
        import h5py
        self.seq_dir = str(seq_dir)
        # resolve symlinked event files (pseudo datasets symlink the h5,
        # reference: sequence_base.py:72-74). realpath, NOT readlink:
        # a relative link target must resolve against the link's own
        # directory, not the process cwd
        self.h5_path = os.path.realpath(ev_h5_path(
            self.seq_dir, cfg.ev_repr_name, cfg.downsample_by_factor_2))
        self._h5 = None
        with h5py.File(self.h5_path, "r") as f:
            self.num_ev_repr = int(f["data"].shape[0])
            self._frame_shape = tuple(f["data"].shape[1:])
            self._frame_dtype = f["data"].dtype
        data = np.load(labels_npz_path(self.seq_dir))
        self._init_labels(cfg, data["labels"],
                          data["objframe_idx_2_label_idx"],
                          np.load(os.path.join(
                              ev_repr_dir(self.seq_dir, cfg.ev_repr_name),
                              "objframe_idx_2_repr_idx.npy")),
                          keep_objframe_idx, label_ratio)

    def _init_labels(self, cfg: DatasetConfig, labels: np.ndarray,
                     objframe_idx_2_label_idx: np.ndarray,
                     objframe_idx_2_repr_idx: np.ndarray,
                     keep_objframe_idx: Optional[Sequence[int]],
                     label_ratio: Optional[float]) -> None:
        self.cfg = cfg
        ds = 2.0 if cfg.downsample_by_factor_2 else None
        self.frame_labels = FrameLabels.from_structured(
            labels, objframe_idx_2_label_idx, cfg.resolution_hw,
            downsample_factor=ds)
        self.objframe_idx_2_repr_idx = np.asarray(objframe_idx_2_repr_idx
                                                  ).astype(np.int64)
        self.repr_idx_2_objframe_idx = {
            int(r): i for i, r in enumerate(self.objframe_idx_2_repr_idx)}

        all_idx = tuple(range(len(self.objframe_idx_2_repr_idx)))
        ratio = cfg.ratio if label_ratio is None else label_ratio
        if keep_objframe_idx is not None:
            self.kept_objframe_idx = tuple(keep_objframe_idx)
        elif 0.0 < ratio < 1.0:
            step = round(1.0 / ratio)
            kept = all_idx[::step]
            self.kept_objframe_idx = kept if kept else (all_idx[-1],)
        else:
            self.kept_objframe_idx = all_idx
        self._kept_set = set(self.kept_objframe_idx)
        self.all_objframe_idx = all_idx

    # -- event reprs ---------------------------------------------------------
    def _file(self):
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.h5_path, "r")
        return self._h5

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def read_ev_repr(self, start: int, stop: int) -> np.ndarray:
        """[stop-start, C, H, W] uint8 (reference: sequence_base.py:184-193)."""
        assert 0 <= start < stop <= self.num_ev_repr
        return self._file()["data"][start:stop]

    def zero_frame(self) -> np.ndarray:
        return np.zeros(self._frame_shape, self._frame_dtype)

    # -- labels ---------------------------------------------------------------
    def labels_at_repr_idx(self, repr_idx: int
                           ) -> Tuple[Optional[Boxes], bool]:
        """(labels, kept). Skipped (WSOD-subsampled) frames return their
        labels with kept=False (reference: sequence_base.py:175-182)."""
        obj_idx = self.repr_idx_2_objframe_idx.get(int(repr_idx))
        if obj_idx is None:
            return None, False
        return self.frame_labels[obj_idx], obj_idx in self._kept_set

    def range_labels(self, start: int, stop: int, time_flip: bool = False
                     ) -> Tuple[List[Optional[Boxes]], List[Optional[Boxes]]]:
        """Labels for reprs in [start, stop): (kept, skipped) lists.

        Under time-flip the label index shifts by tflip_offset because
        labels lag the events (reference: sequence_base.py:147-173)."""
        if time_flip:
            start = start + self.cfg.tflip_offset
            stop = stop + self.cfg.tflip_offset
        kept_out: List[Optional[Boxes]] = []
        skip_out: List[Optional[Boxes]] = []
        for r in range(start, stop):
            lab, kept = self.labels_at_repr_idx(r)
            kept_out.append(lab if (lab is not None and kept and len(lab) > 0)
                            else None)
            skip_out.append(lab if (lab is not None and not kept
                                    and len(lab) > 0) else None)
        return kept_out, skip_out


class ArrayEventSequence(EventSequence):
    """An `EventSequence` whose event reprs are an in-memory [T, C, H, W]
    uint8 array instead of an h5 file; the labels are the same numpy
    arrays the sequence directory holds (`labels.npz`'s `labels` and
    `objframe_idx_2_label_idx`, and `objframe_idx_2_repr_idx.npy`).

    This seam exists because a machine may lack `h5py` while it runs the
    eval path on a card: `data/synthetic.py`'s renderer builds sequences
    in memory, and everything from `WindowedSequence` down is the same
    code for both sources. `seq_dir` is only the sequence's name (the
    batches' `paths`)."""

    def __init__(self, frames: np.ndarray, labels: np.ndarray,
                 objframe_idx_2_label_idx: np.ndarray,
                 objframe_idx_2_repr_idx: np.ndarray, cfg: DatasetConfig,
                 seq_dir: str = "",
                 keep_objframe_idx: Optional[Sequence[int]] = None,
                 label_ratio: Optional[float] = None):
        frames = np.asarray(frames)
        assert frames.ndim == 4, frames.shape
        self.seq_dir = str(seq_dir)
        self.frames = frames
        self.num_ev_repr = int(frames.shape[0])
        self._frame_shape = tuple(frames.shape[1:])
        self._frame_dtype = frames.dtype
        self._h5 = None
        self._init_labels(cfg, labels, objframe_idx_2_label_idx,
                          objframe_idx_2_repr_idx, keep_objframe_idx,
                          label_ratio)

    def read_ev_repr(self, start: int, stop: int) -> np.ndarray:
        assert 0 <= start < stop <= self.num_ev_repr
        return self.frames[start:stop]


def frame_key(seq_dir: str) -> str:
    """"<split>/<sequence name>" of a sequence directory: the key of its
    event frames in an in-memory frame store (`render_dataset_frames`).
    A pseudo dataset's train/<name> keys the frames of the train/<name>
    it was made from."""
    d = os.path.normpath(seq_dir)
    return f"{os.path.basename(os.path.dirname(d))}/{os.path.basename(d)}"


def open_array_sequence(seq_dir: str, frames: np.ndarray, cfg: DatasetConfig,
                        keep_objframe_idx: Optional[Sequence[int]] = None,
                        label_ratio: Optional[float] = None
                        ) -> ArrayEventSequence:
    """The sequence directory `seq_dir` whose labels and index map are on
    disk and whose event frames are `frames` (in memory, not its h5)."""
    data = np.load(labels_npz_path(seq_dir))
    f2r = np.load(os.path.join(ev_repr_dir(seq_dir, cfg.ev_repr_name),
                               "objframe_idx_2_repr_idx.npy"))
    return ArrayEventSequence(frames, data["labels"],
                              data["objframe_idx_2_label_idx"], f2r, cfg,
                              seq_dir=seq_dir,
                              keep_objframe_idx=keep_objframe_idx,
                              label_ratio=label_ratio)


def split_ranges_with_guaranteed_labels(
        label_repr_indices: np.ndarray, window: int) -> List[Tuple[int, int]]:
    """Split a sequence around label gaps > window so every window of a
    training stream contains at least one label
    (reference: sequence_streaming.py:22-51)."""
    if len(label_repr_indices) == 0:
        return []
    gaps = np.flatnonzero(np.diff(label_repr_indices) > window)
    starts = np.concatenate([[0], gaps + 1])
    stops = np.concatenate([gaps, [len(label_repr_indices) - 1]])
    out = []
    for a, b in zip(starts, stops):
        lo = max(int(label_repr_indices[a]) - window + 1, 0)
        hi = int(label_repr_indices[b]) + 1
        out.append((lo, hi))
    return out


class WindowedSequence:
    """Cuts [repr_start, repr_stop) of a sequence into consecutive
    `window`-sized samples for stateful streaming
    (reference: SequenceForIter, sequence_streaming.py:54-277)."""

    def __init__(self, seq: EventSequence, window: int,
                 range_indices: Optional[Tuple[int, int]] = None,
                 start_from_zero: bool = False, time_flip: bool = False):
        self.seq = seq
        self.window = window
        self.time_flip = time_flip
        if len(seq.objframe_idx_2_repr_idx) == 0 and not start_from_zero:
            self.starts, self.stops = [], []
            return
        if range_indices is not None:
            lo, hi = range_indices
        else:
            lo = (0 if start_from_zero else
                  max(int(seq.objframe_idx_2_repr_idx[0]) - window + 1, 0))
            hi = seq.num_ev_repr
        if time_flip:
            # walk windows backwards from the end (sequence_streaming.py:114-121)
            rev_starts = list(range(hi - 1, lo - 1, -window))
            rev_stops = rev_starts[1:] + [lo - 1]
            self.starts = [s + 1 for s in rev_stops]
            self.stops = [s + 1 for s in rev_starts]
        else:
            self.starts = list(range(lo, hi, window))
            self.stops = self.starts[1:] + [hi]

    def __len__(self):
        return len(self.starts)

    def padded_sample(self) -> dict:
        """Fully-padded filler (eval tail balancing,
        reference: sequence_streaming.py:165-180)."""
        L = self.window
        return {
            "path": "",
            "ev_repr": np.stack([self.seq.zero_frame()] * L),
            "labels": [None] * L,
            "skipped_labels": [None] * L,
            "ev_idx": np.full(L, -1, np.int64),
            "is_first_sample": False,
            "is_last_sample": False,
            "is_reversed": False,
            "is_padded": np.ones(L, bool),
        }

    def __getitem__(self, index: int) -> dict:
        start, stop = self.starts[index], self.stops[index]
        n = stop - start
        L = self.window
        assert 0 < n <= L
        ev = self.seq.read_ev_repr(start, stop)
        labels, skipped = self.seq.range_labels(start, stop, self.time_flip)
        ev_idx = np.arange(start, stop, dtype=np.int64)
        padded = np.zeros(n, bool)
        if n < L:
            pad_ev = np.stack([self.seq.zero_frame()] * (L - n))
            pad_lab = [None] * (L - n)
            pad_idx = np.full(L - n, -1, np.int64)
            pad_mask = np.ones(L - n, bool)
            if self.time_flip:   # pad in front; reversed below
                ev = np.concatenate([pad_ev, ev])
                labels = pad_lab + labels
                skipped = pad_lab + skipped
                ev_idx = np.concatenate([pad_idx, ev_idx])
                padded = np.concatenate([pad_mask, padded])
            else:
                ev = np.concatenate([ev, pad_ev])
                labels = labels + pad_lab
                skipped = skipped + pad_lab
                ev_idx = np.concatenate([ev_idx, pad_idx])
                padded = np.concatenate([padded, pad_mask])
        out = {
            "path": self.seq.seq_dir,
            "ev_repr": ev,
            "labels": labels,
            "skipped_labels": skipped,
            "ev_idx": ev_idx,
            "is_first_sample": index == 0,
            "is_last_sample": index == len(self) - 1,
            "is_reversed": self.time_flip,
            "is_padded": padded,
        }
        if self.time_flip:
            out = time_flip_sample(out)
        return out


def time_flip_sample(sample: dict) -> dict:
    """Reverse a window in time. Event frames are reversed along T AND
    along the channel axis: channel order is (polarity, temporal bin)
    flattened, so a full channel flip reverses bins and swaps polarity —
    matching the reference's `x.flip(0)` per frame
    (reference: sequence_base.py:207-227)."""
    sample = dict(sample)
    sample["ev_repr"] = sample["ev_repr"][::-1, ::-1].copy()
    sample["labels"] = sample["labels"][::-1]
    sample["skipped_labels"] = sample["skipped_labels"][::-1]
    sample["ev_idx"] = sample["ev_idx"][::-1].copy()
    sample["is_padded"] = sample["is_padded"][::-1].copy()
    return sample


class RandomAccessSequence:
    """Random-access samples: one kept labeled frame + the `window` event
    reprs ending at it; RNN warm-starts from zero state
    (reference: sequence_rnd.py:16-148)."""

    def __init__(self, seq: EventSequence, window: int,
                 time_flip_allowed: bool = True):
        self.seq = seq
        self.window = window
        # drop leading labeled frames too close to the sequence start:
        # we need `window` reprs ending at the label
        # (reference: sequence_rnd.py:40-59)
        self.usable = [i for i in seq.kept_objframe_idx
                       if int(seq.objframe_idx_2_repr_idx[i]) >= window - 1]
        if not self.usable and len(seq.kept_objframe_idx):
            # keep at least one sample; clamp the window start at 0
            self.usable = [seq.kept_objframe_idx[-1]]

    def __len__(self):
        return len(self.usable)

    def window_range(self, index: int, time_flip: bool = False
                     ) -> Tuple[int, int]:
        """(start, stop) repr range of sample `index`'s window."""
        obj_idx = self.usable[index]
        repr_idx = int(self.seq.objframe_idx_2_repr_idx[obj_idx])
        L = self.window
        if time_flip:
            # place the labeled frame as early as possible so that after
            # reversal it sits at the end (reference: sequence_rnd.py:67-78)
            off = self.seq.cfg.tflip_offset
            start = repr_idx - off
            stop = min(start + L, self.seq.num_ev_repr)
            start = max(stop - L, 0)
        else:
            stop = repr_idx + 1
            start = max(stop - L, 0)
        return start, stop

    def window_class_counts(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(class_ids, counts) of the kept labels inside sample `index`'s
        window — label-only reads, no event IO (for the weighted sampler,
        reference: dataset_rnd.py:230-264)."""
        start, stop = self.window_range(index)
        labels, _ = self.seq.range_labels(start, stop)
        ids = [lab.class_id.astype(np.int32) for lab in labels
               if lab is not None and len(lab)]
        if not ids:
            return np.zeros(0, np.int32), np.zeros(0, np.int64)
        return np.unique(np.concatenate(ids), return_counts=True)

    def __getitem__(self, index: int, time_flip: bool = False) -> dict:
        L = self.window
        start, stop = self.window_range(index, time_flip)
        ev = self.seq.read_ev_repr(start, stop)
        labels, skipped = self.seq.range_labels(start, stop, time_flip)
        n = stop - start
        if n < L:   # short head: pad in front (zero state anyway)
            ev = np.concatenate([np.stack([self.seq.zero_frame()] * (L - n)), ev])
            labels = [None] * (L - n) + labels
            skipped = [None] * (L - n) + skipped
        out = {
            "path": self.seq.seq_dir,
            "ev_repr": ev,
            "labels": labels,
            "skipped_labels": skipped,
            "ev_idx": np.arange(stop - L, stop, dtype=np.int64),
            "is_first_sample": True,     # always reset RNN state
            "is_last_sample": True,
            "is_reversed": time_flip,
            "is_padded": np.concatenate(
                [np.ones(L - n, bool), np.zeros(n, bool)]),
        }
        if time_flip:
            out = time_flip_sample(out)
        if not any(l is not None for l in out["labels"]):
            raise ValueError("window contains no kept labels")
        return out
