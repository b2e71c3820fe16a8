"""Host-side eval loader with explicit stream-slot identity (the eval half
of `leod_tpu/data/loader.py`, copied; the train loaders come with
training).

Stream-slot identity is explicit: batch row b IS stream slot b, the
device keeps one LSTM-state table with one row per slot, and every batch
carries an `is_first` reset flag per slot (reference:
data/utils/stream_sharded_datapipe.py:27-117). A prefetch thread reads
and collates the next batch while the card runs the current one; it does
host work only and never touches CUDA.

Batch dict layout (numpy, time-major):
    ev          [L, B, C, H, W] uint8/float — raw event reprs (unpadded HW)
    is_first    [B] bool
    is_padded   [B, L] bool
    labels      list[L] of list[B] of Optional[Boxes]
    skipped     same (WSOD-withheld labels)
    paths       [B] str, ev_idx [B, L] int
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import DatasetConfig
from ..models.layers import fold_ev_hw
from .labels import Boxes, pad_yolox_batch
from .sequence import EventSequence, WindowedSequence, list_sequence_dirs


def pyramid_indices(n: int) -> Iterator[int]:
    """0,1,..,n-1,n-1,..,1,0,0,1,... (reference: stream_sharded_datapipe.py:31-38)."""
    while True:
        yield from range(n)
        yield from range(n - 1, -1, -1)


def open_split_sequences(cfg: DatasetConfig, split: str,
                         seq_ratio: float = -1.0,
                         label_ratio: Optional[float] = None,
                         keep_objframe_map: Optional[dict] = None,
                         pseudo_mode: bool = False) -> List[EventSequence]:
    """Open all sequences of a split; optional SSOD sequence subsampling
    (every k-th, reference: utils/preprocessing.py:18-28).

    pseudo_mode: keep ALL sequences, but SSOD-skipped ones get an empty
    kept-label list so every frame is pseudo-labeled
    (reference: dataset_streaming.py:71-79)."""
    dirs = list_sequence_dirs(cfg.path, split)
    kept_dirs = set(dirs)
    if 0.0 < seq_ratio < 1.0:
        step = round(1.0 / seq_ratio)
        kept_dirs = set(dirs[::step])
        if not pseudo_mode:
            dirs = sorted(kept_dirs)
    out = []
    for d in dirs:
        keep = keep_objframe_map.get(d) if keep_objframe_map else None
        if pseudo_mode and d not in kept_dirs:
            keep = []
        out.append(EventSequence(d, cfg, keep_objframe_idx=keep,
                                 label_ratio=label_ratio))
    return out


class EvalStreamLoader:
    """Deal full sequences (long -> short, pyramid order) over
    process_shards x batch_slots; pad exhausted slots with filler windows
    (reference: stream_sharded_datapipe.py:27-117)."""

    def __init__(self, sequences: List[EventSequence], cfg: DatasetConfig,
                 batch_size: int, window: Optional[int] = None,
                 shard_index: int = 0, num_shards: int = 1,
                 time_flip: bool = False, start_from_zero: bool = False):
        window = window or cfg.sequence_length
        wins = [WindowedSequence(s, window, time_flip=time_flip,
                                 start_from_zero=start_from_zero)
                for s in sequences]
        wins = [w for w in wins if len(w) > 0]
        assert wins, "split has no non-empty sequences"
        wins.sort(key=len, reverse=True)
        # two-level pyramid deal: first to shards, then to slots. A shard
        # with fewer sequences than batch slots pads with fillers rather
        # than crashing (reference pads short shards the same way,
        # stream_sharded_datapipe.py:59-86).
        shards: List[List[WindowedSequence]] = [[] for _ in range(num_shards)]
        gen = pyramid_indices(num_shards)
        for w in wins:
            shards[next(gen)].append(w)
        mine = shards[shard_index]
        mine.sort(key=len, reverse=True)
        self.slots: List[List[WindowedSequence]] = [[] for _ in range(batch_size)]
        gen = pyramid_indices(batch_size)
        for w in mine:
            self.slots[next(gen)].append(w)
        self.filler = wins[0].padded_sample()
        self.batch_size = batch_size
        # every shard can compute every other shard's length from the same
        # deterministic deal, so all processes agree on a common step count
        # (processes that evaluate shards in lockstep step together)
        self._n_steps = max(
            self._shard_steps(shard, batch_size) for shard in shards)

    @staticmethod
    def _shard_steps(shard: List[WindowedSequence], batch_size: int) -> int:
        lens = [0] * batch_size
        gen = pyramid_indices(batch_size)
        for w in sorted(shard, key=len, reverse=True):
            lens[next(gen)] += len(w)
        return max(lens)

    def __len__(self):
        return self._n_steps

    def __iter__(self):
        iters = []
        for slot in self.slots:
            def chain(ws=slot):
                for w in ws:
                    for i in range(len(w)):
                        yield w[i]
            iters.append(chain())
        n_steps = len(self)
        for _ in range(n_steps):
            rows = []
            for it in iters:
                s = next(it, None)
                rows.append(self.filler if s is None else s)
            yield collate(rows)


def collate(samples: List[dict]) -> dict:
    """Stack B window samples into one time-major batch dict."""
    L = samples[0]["ev_repr"].shape[0]
    ev = np.stack([s["ev_repr"] for s in samples], axis=1)   # [L, B, C, H, W]
    labels = [[s["labels"][t] for s in samples] for t in range(L)]
    skipped = [[s["skipped_labels"][t] for s in samples] for t in range(L)]
    return {
        "ev": ev,
        "is_first": np.array([s["is_first_sample"] for s in samples], bool),
        "is_last": np.array([s["is_last_sample"] for s in samples], bool),
        "is_padded": np.stack([s["is_padded"] for s in samples]),  # [B, L]
        "labels": labels,
        "skipped": skipped,
        "paths": [s["path"] for s in samples],
        "ev_idx": np.stack([s["ev_idx"] for s in samples]),        # [B, L]
        "is_reversed": np.array([s.get("is_reversed", False)
                                 for s in samples], bool),
    }


def harvest_frames(batch: dict, frames_per_slot: int, max_gt: int,
                   pad_hw: Tuple[int, int], use_label_every: int = 1,
                   ignore_label: int = 1024,
                   ignore_image: bool = False,
                   fold_w: int = 1,
                   fold_hw: Optional[Tuple[int, int]] = None) -> dict:
    """Device-ready arrays: pad ev to `pad_hw`, NHWC time-major, and a
    PER-SLOT static-budget list of labeled timesteps + padded labels.

    Per-slot (not global) harvesting keeps the device-side feature gather
    along the time axis only.

    `use_label_every`: on pseudo-dense sequences keep only every k-th
    timestep's pseudo labels; GT frames always kept
    (reference: modules/detection.py:129-148). `ignore_image` drops
    frames whose boxes are ALL ignore-labeled
    (reference: labels.py:716-729).

    `fold_w` > 1 emits ev pre-folded [L, B, H, W/f, f*C] for the S2D
    stem (config.stem_width_fold), folded into the transpose/pad copy
    the host makes anyway. `fold_hw=(fh, fw)` (config.stem_fold_hw)
    additionally folds the H axis ([L, B, H/f, W/f, f*f*C]) so the stem
    runs as a 2x2 stride-1 conv; it overrides fold_w.
    """
    fold_h = 1
    if fold_hw is not None:
        fold_h, fold_w = fold_hw
    ev = batch["ev"]                                    # [L, B, C, H, W]
    L, B = ev.shape[:2]
    h, w = ev.shape[-2:]
    ev = np.transpose(ev, (0, 1, 3, 4, 2))              # -> [L, B, H, W, C]
    if (h, w) != pad_hw:
        ev = np.pad(ev, ((0, 0), (0, 0), (0, pad_hw[0] - h),
                         (0, pad_hw[1] - w), (0, 0)))
    if fold_h > 1:
        assert fold_w == fold_h == 4 and pad_hw[0] % 4 == 0 \
            and pad_hw[1] % 4 == 0, (pad_hw, fold_h, fold_w)
        ev = fold_ev_hw(ev)
    elif fold_w > 1:
        assert pad_hw[1] % fold_w == 0, (pad_hw, fold_w)
        ev = ev.reshape(L, B, pad_hw[0], pad_hw[1] // fold_w,
                        fold_w * ev.shape[-1])

    M = frames_per_slot
    t_idx = np.zeros((B, M), np.int32)
    mask = np.zeros((B, M), bool)
    boxes: List[List[Optional[Boxes]]] = [[None] * M for _ in range(B)]
    counts = np.zeros(B, np.int32)
    demand = np.zeros(B, np.int32)   # labeled frames per slot, uncapped
    dropped = 0
    for t in range(L):
        keep_t = (use_label_every <= 1) or (t % use_label_every == 0)
        for b in range(B):
            lab = batch["labels"][t][b]
            if lab is None or len(lab) == 0:
                continue
            if not keep_t and bool(np.all(lab.is_pseudo())):
                continue
            if ignore_image and bool(np.all(lab.is_ignore(ignore_label))):
                continue
            demand[b] += 1
            n = counts[b]
            if n >= M:
                dropped += 1
                continue     # static budget exceeded (rare; raise budget)
            t_idx[b, n], mask[b, n] = t, True
            boxes[b][n] = lab
            counts[b] = n + 1
    labels = np.stack([pad_yolox_batch(row, max_gt) for row in boxes])
    return {
        "ev": ev, "is_first": batch["is_first"],
        "frame_t": t_idx, "frame_mask": mask,
        "labels": labels, "num_frames": int(counts.sum()),
        "dropped_frames": dropped,
        # the budget this batch actually needed — eval paths auto-regrow
        # to this when dropped_frames > 0 (dropping eval frames would
        # silently bias mAP; reference harvesting is ragged and can never
        # drop, modules/utils/detection.py:27-58)
        "max_slot_frames": int(demand.max()) if B else 0,
        "boxes": boxes,     # host-side Boxes for eval bridging (row-major)
    }


class Prefetcher:
    """Background-thread prefetch wrapper around any batch iterator.
    Exceptions raised inside the prefetch thread are re-raised in the
    consumer (a silently-truncated epoch must never look like a clean
    end-of-iteration)."""

    def __init__(self, it, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for x in self._it:
                if self._stop:
                    break
                self._q.put(x)
                if self._stop:
                    break
        except BaseException as e:                    # noqa: BLE001
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            x = self._q.get()
            if x is self._done:
                if self._error is not None:
                    raise self._error
                return
            yield x

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop the producer and JOIN the thread. Consumers that break
        out of the iteration early (max_batches) must call this, so that
        no reader thread outlives the loop that started it."""
        self._stop = True
        # unblock a producer stuck in q.put (queue full), then wait for
        # it to finish any in-flight item and exit via the _done put
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
