"""Host-side batched loaders with explicit stream-slot identity (copied
from `leod_tpu/data/loader.py`).

Stream-slot identity is explicit: batch row b IS stream slot b, the
device keeps one LSTM-state table with one row per slot, and every batch
carries an `is_first` reset flag per slot (reference:
data/utils/stream_concat_datapipe.py:25-103,
stream_sharded_datapipe.py:27-117). A prefetch thread reads and
collates the next batch while the card runs the current one. The train
loaders draw their random numbers from numpy generators seeded as the
JAX package's are, in the same order, so a seed gives the same batches
byte for byte.

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
from dataclasses import replace
from typing import Iterator, List, Mapping, Optional, Tuple

import numpy as np

from .. import timing
from ..config import DatasetConfig
from ..models.layers import fold_ev_hw
from .augment import SpatialAugmentor, SSODAugmentor
from .labels import Boxes, pad_yolox_batch
from .sequence import (EventSequence, RandomAccessSequence, WindowedSequence,
                       frame_key, open_array_sequence,
                       list_sequence_dirs, split_ranges_with_guaranteed_labels)


def pyramid_indices(n: int) -> Iterator[int]:
    """0,1,..,n-1,n-1,..,1,0,0,1,... (reference: stream_sharded_datapipe.py:31-38)."""
    while True:
        yield from range(n)
        yield from range(n - 1, -1, -1)


def open_split_sequences(cfg: DatasetConfig, split: str,
                         seq_ratio: float = -1.0,
                         label_ratio: Optional[float] = None,
                         keep_objframe_map: Optional[dict] = None,
                         pseudo_mode: bool = False,
                         frames: Optional[Mapping[str, np.ndarray]] = None
                         ) -> List[EventSequence]:
    """Open all sequences of a split; optional SSOD sequence subsampling
    (every k-th, reference: utils/preprocessing.py:18-28).

    pseudo_mode: keep ALL sequences, but SSOD-skipped ones get an empty
    kept-label list so every frame is pseudo-labeled
    (reference: dataset_streaming.py:71-79).

    frames: an in-memory frame store (`data/synthetic.py`
    `render_dataset_frames`): each sequence's labels are read from its
    directory and its event frames from `frames[frame_key(dir)]`, as
    `ArrayEventSequence`s, instead of its h5."""
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
        if frames is not None:
            out.append(open_array_sequence(d, frames[frame_key(d)], cfg,
                                           keep_objframe_idx=keep,
                                           label_ratio=label_ratio))
        else:
            out.append(EventSequence(d, cfg, keep_objframe_idx=keep,
                                     label_ratio=label_ratio))
    return out


# ---------------------------------------------------------------------------
# Train: infinite per-slot shuffled streaming
# ---------------------------------------------------------------------------

class _TrainSlot:
    """One infinite stream: shuffled concatenation of all sequence parts,
    per-part consistent augmentation (reference: stream_concat_datapipe.py
    + RandAugmentIterDataPipe, sequence_streaming.py:280-318)."""

    def __init__(self, sequences: List[EventSequence], window: int,
                 cfg: DatasetConfig, seed: int, ssod: bool = False):
        self.rng = np.random.default_rng(seed)
        self.window = window
        self.cfg = cfg
        self.ssod = ssod
        self.parts: List[Tuple[EventSequence, Tuple[int, int]]] = []
        for seq in sequences:
            kept_reprs = seq.objframe_idx_2_repr_idx[list(seq.kept_objframe_idx)]
            for rng_idx in split_ranges_with_guaranteed_labels(
                    np.asarray(kept_reprs), window):
                self.parts.append((seq, rng_idx))
        assert self.parts, "no labeled stream parts found"
        if ssod:
            # weak/strong paired views for online SSOD
            # (selftrain/online.py); randomized per part like the plain
            # augmentor, no t-flip (it reorders windows)
            self.augmentor = SSODAugmentor(cfg.loading_hw,
                                           cfg.augment_stream, self.rng)
        else:
            self.augmentor = SpatialAugmentor(cfg.loading_hw,
                                              cfg.augment_stream, self.rng)
        self._iter = self._generate()

    def _generate(self):
        while True:
            order = self.rng.permutation(len(self.parts))
            for pi in order:
                seq, rng_idx = self.parts[int(pi)]
                self.augmentor.randomize()
                tflip = (False if self.ssod
                         else self.augmentor.params.tflip)
                win = WindowedSequence(seq, self.window, range_indices=rng_idx,
                                       time_flip=tflip)
                for i in range(len(win)):
                    sample = win[i]
                    if not self.ssod:
                        with timing.span("load.augment"):
                            out = self.augmentor.apply(sample)
                        yield out
                        continue
                    with timing.span("load.augment"):
                        weak, strong = self.augmentor(sample)
                    yield {"weak": weak, "strong": strong,
                           "weak_params": replace(self.augmentor.weak.params),
                           "strong_applied": replace(
                               self.augmentor.strong.last_applied)}

    def __next__(self):
        return next(self._iter)


class StreamTrainLoader:
    """B parallel infinite slots; every `next()` yields one batch whose row b
    continues slot b's stream (reference: stream_concat_datapipe.py:63-103)."""

    def __init__(self, sequences: List[EventSequence], cfg: DatasetConfig,
                 batch_size: int, seed: int = 0, slot_offset: int = 0,
                 ssod: bool = False):
        """slot_offset: first GLOBAL slot id this loader feeds — a
        process that feeds a slice of a global slot table gets stream
        seeds no other process has.

        ssod=True yields paired batches {"weak", "strong", "weak_params",
        "strong_applied"} — two collated views of the same windows plus
        the per-slot transform records (see selftrain/online.py)."""
        self.ssod = ssod
        self.slots = [
            _TrainSlot(sequences, cfg.sequence_length, cfg,
                       seed * 1000 + slot_offset + b, ssod=ssod)
            for b in range(batch_size)]

    def __iter__(self):
        while True:
            pairs = [next(s) for s in self.slots]
            if not self.ssod:
                yield collate(pairs)
                continue
            yield {"weak": collate([p["weak"] for p in pairs]),
                   "strong": collate([p["strong"] for p in pairs]),
                   "weak_params": [p["weak_params"] for p in pairs],
                   "strong_applied": [p["strong_applied"] for p in pairs]}


class RandomTrainLoader:
    """Uniform (or class-frequency weighted) random-access samples; RNN
    always resets (reference: dataset_rnd.py:95-152, weighted sampler
    :230-264)."""

    def __init__(self, sequences: List[EventSequence], cfg: DatasetConfig,
                 batch_size: int, seed: int = 0, slot_offset: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed + 77 + 7919 * slot_offset)
        self.datasets = [RandomAccessSequence(s, cfg.sequence_length)
                         for s in sequences]
        self.datasets = [d for d in self.datasets if len(d) > 0]
        self.sizes = np.array([len(d) for d in self.datasets])
        self.cum = np.cumsum(self.sizes)
        # cumulative distribution once, searchsorted per draw
        self.cum_probs = (np.cumsum(self._sample_weights())
                          if cfg.weighted_sampling else None)
        self.augmentor = SpatialAugmentor(cfg.loading_hw, cfg.augment_random,
                                          self.rng)

    def _sample_weights(self) -> np.ndarray:
        """Per-sample probability ~ sum_c count_c(sample) / count_c(all):
        rare classes and box-dense windows are sampled more often
        (reference: dataset_rnd.py:228-264). Label-only reads."""
        per_sample = []
        class2count: dict = {}
        for d in self.datasets:
            for i in range(len(d)):
                ids, counts = d.window_class_counts(i)
                per_sample.append((ids, counts))
                for c, n in zip(ids, counts):
                    class2count[int(c)] = class2count.get(int(c), 0) + int(n)
        w = np.array([
            sum(n / max(class2count[int(c)], 1) for c, n in zip(ids, counts))
            for ids, counts in per_sample], np.float64)
        total = w.sum()
        if total <= 0:
            return np.full(len(w), 1.0 / max(len(w), 1))
        return w / total

    def _sample_one(self) -> dict:
        for _ in range(32):
            if self.cum_probs is not None:
                gidx = int(np.searchsorted(self.cum_probs,
                                           self.rng.random(), side="right"))
                gidx = min(gidx, len(self.cum_probs) - 1)
            else:
                gidx = int(self.rng.integers(0, self.cum[-1]))
            di = int(np.searchsorted(self.cum, gidx, side="right"))
            li = gidx - (self.cum[di - 1] if di > 0 else 0)
            self.augmentor.randomize()
            tflip = self.augmentor.params.tflip
            try:
                s = self.datasets[di].__getitem__(int(li), time_flip=tflip)
            except ValueError:
                continue    # rand-another on label-less windows
            with timing.span("load.augment"):
                out = self.augmentor.apply(s)
            if any(l is not None for l in out["labels"]):
                return out
        raise RuntimeError("could not sample a labeled random-access window")

    def __iter__(self):
        while True:
            yield collate([self._sample_one() for _ in range(self.batch_size)])


class MixedTrainLoader:
    """Concat stream + random batches along the batch axis each step
    (reference: modules/utils/detection.py:226-240, modules/data/genx.py:120-144).
    Stream rows occupy slots [0, B_stream); random rows always reset."""

    def __init__(self, stream_loader: StreamTrainLoader,
                 random_loader: RandomTrainLoader):
        self.stream_loader = stream_loader
        self.random_loader = random_loader

    def __iter__(self):
        for bs, br in zip(iter(self.stream_loader), iter(self.random_loader)):
            yield concat_batches([bs, br])


# ---------------------------------------------------------------------------
# Eval: deterministic full-coverage streaming
# ---------------------------------------------------------------------------

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
    with timing.span("load.collate"):
        return _collate(samples)


def _collate(samples: List[dict]) -> dict:
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


def concat_batches(batches: List[dict]) -> dict:
    L = len(batches[0]["labels"])
    out = {
        "ev": np.concatenate([b["ev"] for b in batches], axis=1),
        "is_first": np.concatenate([b["is_first"] for b in batches]),
        "is_last": np.concatenate([b["is_last"] for b in batches]),
        "is_padded": np.concatenate([b["is_padded"] for b in batches]),
        "labels": [sum((b["labels"][t] for b in batches), [])
                   for t in range(L)],
        "skipped": [sum((b["skipped"][t] for b in batches), [])
                    for t in range(L)],
        "paths": sum((b["paths"] for b in batches), []),
        "ev_idx": np.concatenate([b["ev_idx"] for b in batches]),
        "is_reversed": np.concatenate([b["is_reversed"] for b in batches]),
    }
    return out


def hflip_batch(batch: dict) -> dict:
    """The batch with its h-flipped copy as B more slots (h-flip TTA):
    ev [L, 2B, ...], is_first, labels and is_padded doubled; the rest as
    the batch's (reference: modules/utils/tta.py)."""
    out = dict(batch)
    out["ev"] = np.concatenate([batch["ev"], batch["ev"][..., ::-1]], axis=1)
    out["is_first"] = np.concatenate([batch["is_first"]] * 2)
    out["labels"] = [row * 2 for row in batch["labels"]]
    out["is_padded"] = np.concatenate([batch["is_padded"]] * 2)
    return out


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
    with timing.span("harvest.fold"):
        ev = _fold(batch["ev"], pad_hw, fold_w, fold_hw)
    with timing.span("harvest.labels"):
        out = _pair_labels(batch, frames_per_slot, max_gt, use_label_every,
                           ignore_label, ignore_image)
    return {"ev": ev, **out}


def _fold(ev: np.ndarray, pad_hw: Tuple[int, int], fold_w: int,
          fold_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """ev [L, B, C, H, W] transposed to NHWC, padded to `pad_hw` and
    folded for the stem (`harvest_frames`)."""
    fold_h = 1
    if fold_hw is not None:
        fold_h, fold_w = fold_hw
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
    return ev


def _pair_labels(batch: dict, frames_per_slot: int, max_gt: int,
                 use_label_every: int, ignore_label: int,
                 ignore_image: bool) -> dict:
    """The per-slot budget of labeled timesteps and their padded labels
    (`harvest_frames`), all but the frames."""
    L, B = batch["ev"].shape[:2]
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
        "is_first": batch["is_first"],
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
    end-of-iteration). Traced (`timing`) as the thread's "prefetch.put"
    spans (the wait for room in the queue) and the counters
    "prefetch.gets" and "prefetch.empty_gets" (gets that found the queue
    empty: the consumer waited on the thread)."""

    def __init__(self, it, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _fill(self):
        try:
            for x in self._it:
                if self._stop:
                    break
                with timing.span("prefetch.put"):
                    self._q.put(x)
                if self._stop:
                    break
        except BaseException as e:                    # noqa: BLE001
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            if timing.tracing():
                timing.count("prefetch.gets")
                if self._q.empty():
                    timing.count("prefetch.empty_gets")
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
        out of the iteration early (max_batches, fit() at max_steps)
        must call this, so that no reader thread outlives the loop that
        started it."""
        self._stop = True
        # unblock a producer stuck in q.put (queue full), then wait for
        # it to finish any in-flight item and exit via the _done put
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
