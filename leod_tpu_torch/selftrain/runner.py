"""Pseudo-label generation runner (port of `leod_tpu/selftrain/runner.py`).

Streams the training split through the teacher (optionally with h-flip
TTA in-batch and a second time-flipped pass), converts filtered
predictions to pseudo labels, evaluates them against withheld GT, and
writes the new dataset (reference: modules/pseudo_labeler.py:410-797 +
predict.py:118-278).

On the card each batch is one eval step of the L-frame window over B
slots (2B under h-flip: the second half is the mirrored window) through
the block and ConvLSTM kernels, then one NMS launch over every slot's
every frame (2B x L images); the host routes the kept detections into
per-sequence recorders.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device, timing
from ..config import ExperimentConfig, stem_fold_hw
from ..data.loader import (EvalStreamLoader, Prefetcher, harvest_frames,
                           hflip_batch, open_split_sequences)
from ..data.sequence import EventSequence, list_sequence_dirs
from ..eval.prophesee import PropheseeEvaluator, boxes_to_prophesee
from ..models.detector import Detector
from ..ops.nms import postprocess
from ..train.step import make_eval_step
from .filters import evaluate_pseudo_labels, pred_to_label
from .pseudo_labeler import PseudoLabelConfig, SequenceRecorder


class _SlotLens:
    """Per-slot processed-frame counters (reference: SeqLens,
    modules/utils/detection.py:160-193)."""

    def __init__(self, n: int):
        self.lens = np.zeros(n, np.int64)

    def reset(self, is_first: np.ndarray):
        self.lens[is_first] = 0

    def add(self, l: int):
        self.lens += l


def harvest_all_frames(batch: dict, cfg: ExperimentConfig) -> dict:
    """Every timestep of every slot as a frame to predict on: the window
    padded and folded, frame_t = 0..L-1 for each slot, every frame
    valid; the host decides afterwards what to keep."""
    L, B = batch["ev"].shape[:2]
    hb = harvest_frames({**batch, "labels": [[None] * B for _ in range(L)]},
                        frames_per_slot=L, max_gt=1,
                        pad_hw=cfg.model.backbone.in_res_hw,
                        fold_hw=stem_fold_hw(cfg.model))
    hb["frame_t"] = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    hb["frame_mask"] = np.ones_like(hb["frame_t"], bool)
    return hb


class PseudoLabelRunner:
    def __init__(self, det: Detector, cfg: ExperimentConfig,
                 pl_cfg: PseudoLabelConfig, save_dir: str,
                 batch_size: Optional[int] = None,
                 shard_index: int = 0, num_shards: int = 1, *,
                 sequences: Optional[List[EventSequence]] = None,
                 plain: bool = False, device="cuda",
                 on_batch: Optional[Callable] = None,
                 timings: Optional[Dict[str, list]] = None):
        """`det`: the teacher, an inference `Detector` on `device`
        (`cuda` unless the caller asks for `cpu`); plain=True runs the
        kernels' plain versions.

        shard_index/num_shards: deterministic sequence sharding (the
        same pyramid deal as sharded eval): each shard records and saves
        only its own sequences, and the union of shards equals a full
        run.

        `sequences` (already open, e.g. `ArrayEventSequence`s, with the
        WSOD label ratio applied) replaces the train split's directory;
        they are not closed. on_batch(pass_index, batch_index, harvested,
        preds, dets, valid) is called after every batch's NMS (dets and
        valid as numpy). `timings`, where given, collects host ms a
        batch under "harvest_ms", "step_ms" (ending in a device
        synchronize), "postprocess_ms" and "consume_ms", and seconds
        under "pass_s" and "save_s", and turns the port's tracer on
        while the passes run (`timing`)."""
        self.dev = resolve_device(device)
        if det.device.type != self.dev.type:
            raise ValueError(f"detector is on {det.device}, the runner "
                             f"asked for {self.dev}")
        self.det = det
        self.cfg = cfg
        self.pl = pl_cfg
        self.save_dir = save_dir
        self.shard_index, self.num_shards = shard_index, num_shards
        self.batch_size = batch_size or cfg.training.batch_size_eval
        self.sequences = sequences
        self.plain = plain
        self.on_batch = on_batch
        self.timings = timings
        self.recorders: Dict[str, SequenceRecorder] = {}
        self.quality = PropheseeEvaluator(cfg.dataset.name,
                                          cfg.dataset.downsample_by_factor_2)
        self._gt_pairs: Tuple[List, List] = ([], [])
        self._sources: Dict[str, EventSequence] = {}

    # -- one streaming pass ---------------------------------------------------
    def _run_pass(self, time_flip: bool, pass_index: int):
        cfg, dst, pl = self.cfg, self.cfg.dataset, self.pl
        seqs = self.sequences
        if seqs is None:
            seqs = open_split_sequences(dst, "train",
                                        seq_ratio=dst.train_ratio,
                                        label_ratio=dst.ratio,
                                        pseudo_mode=True)
        self._sources.update((s.seq_dir, s) for s in seqs)
        B = min(self.batch_size, len(seqs))
        loader = EvalStreamLoader(seqs, dst, B, time_flip=time_flip,
                                  start_from_zero=True,
                                  shard_index=self.shard_index,
                                  num_shards=self.num_shards)
        L = dst.sequence_length
        hflip = pl.tta_hflip
        B_dev = B * 2 if hflip else B
        eval_step = make_eval_step(self.det, plain=self.plain,
                                   device=self.dev)
        states = self.det.init_states(B_dev)
        lens = _SlotLens(B)
        pp = cfg.model.postprocess
        n_cls = cfg.model.head.num_classes
        hw = dst.loading_hw

        try:
            with Prefetcher(iter(loader)) as prefetcher:
                # closed on exceptions too: no reader thread outlives the
                # pass
                for bi, batch in enumerate(prefetcher):
                    with timing.lap(self.timings, "harvest_ms", batch=bi):
                        lens.reset(batch["is_first"])
                        hb = harvest_all_frames(
                            hflip_batch(batch) if hflip else batch, cfg)
                    with timing.lap(self.timings, "step_ms",
                                    self.det.device, batch=bi):
                        states, preds = eval_step(states, hb)
                    with timing.lap(self.timings, "postprocess_ms",
                                    batch=bi):
                        dets, valid = postprocess(
                            preds, num_classes=n_cls,
                            conf_threshold=pp.confidence_threshold,
                            nms_threshold=pp.nms_threshold,
                            pre_topk=pp.pre_nms_topk, max_dets=pp.max_dets,
                            plain=self.plain)
                        dets = dets.cpu().numpy()
                        valid = valid.cpu().numpy()
                    with timing.lap(self.timings, "consume_ms", batch=bi):
                        self._consume(batch, dets, valid, L, B, hflip,
                                      time_flip, hw, lens.lens.copy())
                    lens.add(L)
                    if self.on_batch is not None:
                        self.on_batch(pass_index, bi, hb, preds, dets, valid)
        finally:
            if self.sequences is None:
                for s in seqs:
                    s.close()

    def _consume(self, batch, dets, valid, L, B, hflip, time_flip, hw,
                 lens_before):
        """Route per-frame detections into recorders + quality eval."""
        cfg, pl = self.cfg, self.pl
        dst = cfg.dataset
        views = [(0, False)] + ([(B, True)] if hflip else [])
        for b in range(B):
            path = batch["paths"][b]
            if not path:
                continue
            if path not in self.recorders:
                self.recorders[path] = SequenceRecorder(
                    path, 2.0 if dst.downsample_by_factor_2 else 1.0,
                    pl, cfg.model.postprocess, source=self._sources[path])
            rec = self.recorders[path]
            for off, is_h in views:
                row_labels: List[Optional] = [None] * L
                for t in range(L):
                    if batch["is_padded"][b, t] or batch["ev_idx"][b, t] < 0:
                        continue
                    gt = batch["labels"][t][b]
                    skipped_gt = batch["skipped"][t][b]
                    if gt is not None and pl.use_gt:
                        # keep the GT on its frame (recorded once)
                        if not is_h and not time_flip:
                            row_labels[t] = gt
                        continue
                    # skip predicting on frames too soon after a state
                    # reset: not enough history for reliable predictions
                    # (reference: pseudo_labeler.py:525-531)
                    if lens_before[b] + t < pl.skip_first_t:
                        continue
                    row = (b + off) * L + t
                    d = dets[row][valid[row]]
                    pseudo = pred_to_label(
                        d if len(d) else None, hw,
                        obj_thresh=pl.obj_thresh, cls_thresh=pl.cls_thresh,
                        dataset=dst.name,
                        downsampled_by_2=dst.downsample_by_factor_2)
                    row_labels[t] = pseudo if len(pseudo) else None
                    if skipped_gt is not None and not is_h and not time_flip:
                        self._gt_pairs[0].append(skipped_gt)
                        self._gt_pairs[1].append(pseudo)
                        pred_arr = (np.concatenate(
                            [pseudo.xyxy(), pseudo.objectness[:, None],
                             pseudo.class_confidence[:, None],
                             pseudo.class_id[:, None]], -1)
                            if len(pseudo) else None)
                        gt_p, dt_p = boxes_to_prophesee(skipped_gt, pred_arr)
                        self.quality.add_labels([gt_p])
                        self.quality.add_predictions([dt_p])
                rec.update(row_labels, batch["ev_idx"][b].tolist(),
                           bool(batch["is_last"][b]),
                           batch["is_padded"][b].tolist(),
                           is_hflip=is_h, is_tflip=time_flip,
                           tflip_offset=dst.tflip_offset)

    # -- full run ---------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        train_dir = os.path.join(self.save_dir, "train")
        if self.num_shards == 1:
            assert not os.path.exists(train_dir), \
                f"{train_dir} already exists"
        elif os.path.isdir(train_dir):
            # shards share save_dir, so the dir may legitimately hold the
            # OTHER shards' output — but never sequences outside this
            # run's deterministic deal (a stale previous run would
            # silently mix teachers). Per-sequence collisions within the
            # deal still fail fast in SequenceRecorder.save (mkdir
            # exist_ok=False).
            names = ([s.seq_dir for s in self.sequences]
                     if self.sequences is not None else
                     list_sequence_dirs(self.cfg.dataset.path, "train"))
            expected = {os.path.basename(d.rstrip("/")) for d in names}
            stale = set(os.listdir(train_dir)) - expected
            assert not stale, (
                f"{train_dir} contains sequences from a previous run: "
                f"{sorted(stale)[:5]}")
        os.makedirs(train_dir, exist_ok=True)
        passes = [False] + ([True] if self.pl.tta_tflip else [])
        with timing.recording(self.timings is not None):
            for i, time_flip in enumerate(passes):
                t0 = time.perf_counter()
                self._run_pass(time_flip, i)
                if self.timings is not None:
                    self.timings.setdefault("pass_s", []).append(
                        time.perf_counter() - t0)
        # quality metrics vs withheld GT
        metrics: Dict[str, float] = {}
        if self._gt_pairs[0]:
            classes = self.cfg.dataset.classes
            metrics.update(evaluate_pseudo_labels(
                self._gt_pairs[0], self._gt_pairs[1],
                [True] * len(self._gt_pairs[0]),
                self.cfg.model.head.num_classes, classes, prefix="ssod/"))
            coco = self.quality.evaluate()
            if coco:
                metrics.update({f"ssod/teacher_{k}": v
                                for k, v in coco.items()})
        # save every sequence
        t0 = time.perf_counter()
        for path, rec in self.recorders.items():
            assert rec.ended, f"{path} never reached end-of-stream"
            rec.save(self.save_dir, self.cfg.dataset)
        if self.timings is not None:
            self.timings["save_s"] = time.perf_counter() - t0
        return metrics
