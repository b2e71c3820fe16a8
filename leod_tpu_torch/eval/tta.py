"""Test-time-augmentation evaluation (port of `leod_tpu/eval/tta.py`;
reference: modules/utils/tta.py).

Runs up to four views over each sequence — normal, h-flip (in-batch),
t-flip (reversed streaming pass), t-flip+h-flip — keeps predictions only
at GT-labeled frames, re-aligns flipped views (h-flip-back; t-flip index
offset), merges each frame's pooled predictions by NMS, then evaluates
with the Prophesee COCO protocol. On the card each batch is one eval
step (block and ConvLSTM kernels, 2B slots under h-flip) and one NMS
launch over the harvested frames.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import resolve_device, timing
from ..config import ExperimentConfig, PostprocessConfig, stem_fold_hw
from ..data.labels import Boxes
from ..data.loader import (EvalStreamLoader, Prefetcher, harvest_frames,
                           hflip_batch, open_split_sequences)
from ..data.sequence import EventSequence
from ..models.detector import Detector
from ..ops.nms import batched_nms_numpy, postprocess
from ..parallel import distributed as pdist
from ..train.step import make_eval_step
from .prophesee import PropheseeEvaluator, boxes_to_prophesee


def merge_view_preds(pred_rows: np.ndarray, pp: PostprocessConfig
                     ) -> np.ndarray:
    """NMS-merge pooled (x1,y1,x2,y2,obj,cls_conf,cls_id) rows from
    multiple TTA views (reference: tta.py:18-61)."""
    if len(pred_rows) == 0:
        return pred_rows
    score = pred_rows[:, 4] * pred_rows[:, 5]
    keep = score >= pp.confidence_threshold
    rows = pred_rows[keep]
    if len(rows) == 0:
        return rows
    kept = batched_nms_numpy(rows[:, :4], rows[:, 4] * rows[:, 5],
                             rows[:, 6], pp.nms_threshold)
    return rows[kept]


class _SeqResult:
    """Per-sequence accumulation (reference: EventSeqResult, tta.py:64-197)."""

    def __init__(self, img_w: float):
        self.img_w = img_w
        self.preds: Dict[int, List[np.ndarray]] = {}
        self.gts: Dict[int, Boxes] = {}
        self.ended = False
        self.augmented = False

    def add(self, ev_idx: int, gt: Optional[Boxes], pred: np.ndarray,
            is_hflip: bool, is_tflip: bool, tflip_offset: int):
        if is_hflip or is_tflip:
            self.augmented = True
        if is_hflip and len(pred):
            pred = pred.copy()
            w = pred[:, 2] - pred[:, 0]
            pred[:, 0] = self.img_w - 1 - pred[:, 0] - w
            pred[:, 2] = pred[:, 0] + w
        if is_tflip:
            ev_idx = ev_idx + tflip_offset
        self.preds.setdefault(ev_idx, []).append(pred)
        if gt is not None and not is_hflip and not is_tflip:
            assert ev_idx not in self.gts
            self.gts[ev_idx] = gt


def _bridge(results: Dict[str, _SeqResult], batch: dict, hb: dict,
            dets: np.ndarray, valid: np.ndarray, B_eff: int,
            time_flip: bool, dst) -> None:
    """Each harvested labeled frame's kept detections into its
    sequence's record, at its repr index (h-flipped rows beside the
    normal view's)."""
    Mslot = hb["frame_t"].shape[1]
    for brow in range(len(hb["boxes"])):
        b = brow % B_eff
        is_h = brow >= B_eff
        path = batch["paths"][b]
        if not path:
            continue
        rec = results.setdefault(path, _SeqResult(dst.loading_hw[1]))
        for m in range(Mslot):
            gt = hb["boxes"][brow][m]
            if gt is None:
                continue
            t = int(hb["frame_t"][brow, m])
            ev_i = int(batch["ev_idx"][b, t])
            if ev_i < 0:
                continue
            row = brow * Mslot + m
            d = dets[row][valid[row]]
            rec.add(ev_i, gt if not is_h else None, d,
                    is_hflip=is_h, is_tflip=time_flip,
                    tflip_offset=dst.tflip_offset)


@timing.traced
def run_tta_eval(det: Detector, cfg: ExperimentConfig,
                 split: str = "test", hflip: bool = True, tflip: bool = True,
                 batch_size: Optional[int] = None,
                 conf_threshold: Optional[float] = None,
                 frames_per_slot: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None,
                 evaluator: Optional[PropheseeEvaluator] = None, *,
                 sequences: Optional[List[EventSequence]] = None,
                 plain: bool = False, device="cuda",
                 on_batch: Optional[Callable] = None,
                 timings: Optional[Dict[str, list]] = None
                 ) -> Optional[Dict[str, float]]:
    """TTA evaluation of a split -> Prophesee COCO metrics.

    shard_index/num_shards: deterministic sequence sharding (same
    pyramid deal as run_streaming_eval); pass one `evaluator` per shard
    and PropheseeEvaluator.merge the buffers before evaluating — the
    union of shards equals a full run; with an external evaluator the
    return value is None (the caller evaluates the merged buffers once).
    The t-flip pass reuses the identical deal, so each shard sees both
    views of exactly its own sequences. Defaults: under a process group
    each process evaluates its own shard and the evaluators' buffers are
    all-gathered before the COCO eval, so every rank returns identical
    metrics, exactly like run_streaming_eval; one process evaluates the
    whole split.

    `sequences` (already open, e.g. `ArrayEventSequence`s) replaces the
    split's directory; they are not closed. `det` must live on `device`
    (`cuda` unless the caller asks for `cpu`); plain=True runs the
    kernels' plain versions. on_batch(pass_index, batch_index,
    harvested, preds, dets, valid) is called after every NMS (dets and
    valid as numpy). `timings`, where given, collects host ms a batch
    under "harvest_ms", "step_ms" (ending in a device synchronize),
    "postprocess_ms" and "bridge_ms", and "evaluate_ms" once, and turns
    the port's tracer on while it runs (`timing`)."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, eval asked for {dev}")
    shard_index, num_shards, sync_metrics = pdist.eval_shard(shard_index,
                                                             num_shards)
    if not sync_metrics and num_shards > 1 and evaluator is None:
        # a per-shard AP is statistically meaningless — the caller must
        # collect one evaluator per shard and merge before evaluating
        raise ValueError(
            "explicit sharding needs an external `evaluator` "
            "(merge the shards' buffers, then evaluate once)")
    dst = cfg.dataset
    pp = cfg.model.postprocess
    if conf_threshold is not None:
        pp = dataclasses.replace(pp, confidence_threshold=conf_threshold)
    from ..train.trainer import default_frames_per_slot
    B = batch_size or cfg.training.batch_size_eval
    n_cls = cfg.model.head.num_classes
    L = dst.sequence_length
    M = frames_per_slot or default_frames_per_slot(L)
    eval_step = make_eval_step(det, plain=plain, device=dev)
    results: Dict[str, _SeqResult] = {}

    passes = [False] + ([True] if tflip else [])
    for pass_index, time_flip in enumerate(passes):
        seqs = sequences if sequences is not None else open_split_sequences(
            dst, split, seq_ratio={"val": dst.val_ratio,
                                   "test": dst.test_ratio}.get(split, -1.0))
        B_eff = min(B, len(seqs))
        loader = EvalStreamLoader(seqs, dst, B_eff, time_flip=time_flip,
                                  shard_index=shard_index,
                                  num_shards=num_shards)
        B_dev = B_eff * 2 if hflip else B_eff
        states = det.init_states(B_dev)
        try:
            with Prefetcher(iter(loader)) as prefetcher:
                for bi, batch in enumerate(prefetcher):
                    with timing.lap(timings, "harvest_ms", batch=bi):
                        dev_in = hflip_batch(batch) if hflip else batch
                        while True:
                            hb = harvest_frames(
                                dev_in, M, cfg.model.head.max_gt,
                                cfg.model.backbone.in_res_hw,
                                fold_hw=stem_fold_hw(cfg.model))
                            if not hb["dropped_frames"]:
                                break
                            # eval must never drop labeled frames (same
                            # auto-regrow as run_streaming_eval)
                            M = int(hb["max_slot_frames"])
                            print(f"tta harvest budget grown to {M}/slot",
                                  flush=True)
                    with timing.lap(timings, "step_ms", det.device,
                                    batch=bi):
                        states, preds = eval_step(states, hb)
                    if not time_flip:
                        # end-of-stream bookkeeping must run even for
                        # steps with ZERO harvested frames: a sequence
                        # whose final window keeps no labels still ends
                        # here, and the `assert rec.ended` below depends
                        # on seeing it
                        for b in range(B_eff):
                            p = batch["paths"][b]
                            if p and bool(batch["is_last"][b]):
                                results.setdefault(p, _SeqResult(
                                    dst.loading_hw[1])).ended = True
                    if hb["num_frames"] == 0:
                        continue
                    with timing.lap(timings, "postprocess_ms", batch=bi):
                        dets, valid = postprocess(
                            preds, num_classes=n_cls,
                            conf_threshold=pp.confidence_threshold,
                            nms_threshold=pp.nms_threshold,
                            pre_topk=pp.pre_nms_topk, max_dets=pp.max_dets,
                            plain=plain)
                        dets = dets.cpu().numpy()
                        valid = valid.cpu().numpy()
                    with timing.lap(timings, "bridge_ms", batch=bi):
                        _bridge(results, batch, hb, dets, valid, B_eff,
                                time_flip, dst)
                    if on_batch is not None:
                        on_batch(pass_index, bi, hb, preds, dets, valid)
        finally:
            if sequences is None:
                for s in seqs:
                    s.close()

    external = evaluator is not None
    if not external:
        evaluator = PropheseeEvaluator(dst.name, dst.downsample_by_factor_2)
    t0 = time.perf_counter()
    for path, rec in results.items():
        # a truncated normal pass must fail loudly, not silently evaluate
        # a partial sequence (reference: predict.py:219 asserts
        # end-of-stream before saving)
        assert rec.ended, f"{path} never reached end-of-stream"
        for ev_i in sorted(rec.gts.keys()):
            pooled = np.concatenate(
                [p for p in rec.preds.get(ev_i, []) if len(p)] or
                [np.zeros((0, 7), np.float32)])
            merged = merge_view_preds(pooled, pp) if rec.augmented else pooled
            gt_p, dt_p = boxes_to_prophesee(rec.gts[ev_i],
                                            merged if len(merged) else None)
            evaluator.add_labels([gt_p])
            evaluator.add_predictions([dt_p])
    if sync_metrics:
        pdist.allgather_evaluator(evaluator)
    if external:
        # the caller merges shard evaluators and evaluates ONCE
        return None
    metrics = evaluator.evaluate()
    if timings is not None:
        timings["evaluate_ms"] = (time.perf_counter() - t0) * 1e3
    return metrics
