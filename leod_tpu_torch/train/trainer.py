"""Streaming evaluation of a split (port of
`leod_tpu/train/trainer.py:68-82,155-293`; the `Trainer` comes with
training).

A host prefetch thread reads and collates windows; each batch's labeled
frames are harvested into a static budget, the eval step runs the
backbone over the L-frame window on the card, the fixed-shape NMS runs
over the harvested frames, and the Prophesee/COCO evaluator scores them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from .. import resolve_device
from ..config import ExperimentConfig, stem_fold_hw
from ..data.loader import (EvalStreamLoader, Prefetcher, harvest_frames,
                           open_split_sequences)
from ..data.sequence import EventSequence
from ..eval.prophesee import PropheseeEvaluator, boxes_to_prophesee
from ..models.detector import Detector
from ..ops.nms import postprocess
from .step import make_eval_step


def default_frames_per_slot(seq_len: int, use_label_every: int = 1) -> int:
    """Static per-slot harvest budget.

    Real Gen1/Gen4 GT labels arrive at <= 4 Hz vs 20 Hz reprs, so
    ceil(L/5)+1 covers them with slack. When training on pseudo-dense
    datasets with `use_label_every` subsampling, the kept pseudo frames
    are denser: budget additionally covers ceil(L/use_label_every)+1.
    The loader reports dropped_frames when the budget is too small."""
    budget = max(2, (seq_len + 4) // 5 + 1)
    if use_label_every > 1:
        budget = max(budget, -(-seq_len // use_label_every) + 1)
    return budget


def run_streaming_eval(det: Detector, cfg: ExperimentConfig,
                       split: str = "val", batch_size: Optional[int] = None,
                       frames_per_slot: Optional[int] = None,
                       conf_threshold: Optional[float] = None,
                       max_batches: Optional[int] = None,
                       time_flip: bool = False,
                       shard_index: int = 0, num_shards: int = 1,
                       evaluator: Optional[PropheseeEvaluator] = None, *,
                       sequences: Optional[List[EventSequence]] = None,
                       plain: bool = False, device="cuda",
                       on_batch: Optional[Callable] = None,
                       timings: Optional[Dict[str, list]] = None
                       ) -> Optional[Dict[str, float]]:
    """Full streaming evaluation of a split -> Prophesee COCO metrics
    (reference: modules/detection.py:300-463, val.py).

    The split's sequences are dealt over B stream slots (shard
    `shard_index` of `num_shards`); with several shards, pass one
    `evaluator` per shard and combine them with
    `PropheseeEvaluator.merge`. `sequences` (already open, e.g.
    `ArrayEventSequence`s) replaces the split's directory. `det` must live
    on `device` (`cuda` unless the caller asks for `cpu`); plain=True
    runs the kernels' plain versions.

    on_batch(batch_index, harvested, preds, dets, valid) is called after
    the NMS of every batch with labeled frames (dets and valid as numpy).
    `timings`, where given, collects host ms a batch under "harvest_ms",
    "step_ms" (ending in a device synchronize), "postprocess_ms" and
    "bridge_ms", and "evaluate_ms" once."""
    dev = resolve_device(device)
    if det.device.type != dev.type:
        raise ValueError(f"detector is on {det.device}, eval asked for {dev}")
    dst = cfg.dataset
    B = batch_size or cfg.training.batch_size_eval
    seqs = sequences if sequences is not None else open_split_sequences(
        dst, split, seq_ratio={"val": dst.val_ratio,
                               "test": dst.test_ratio}.get(split, -1.0))
    if not seqs:
        return None
    time_flip = time_flip or dst.reverse_event_order
    B = min(B, len(seqs))
    loader = EvalStreamLoader(seqs, dst, B, time_flip=time_flip,
                              shard_index=shard_index, num_shards=num_shards)
    M = frames_per_slot or default_frames_per_slot(dst.sequence_length)
    pp = cfg.model.postprocess
    conf = conf_threshold if conf_threshold is not None else pp.confidence_threshold

    eval_step = make_eval_step(det, plain=plain, device=dev)
    if evaluator is None:
        evaluator = PropheseeEvaluator(dst.name, dst.downsample_by_factor_2)
    states = det.init_states(B)
    n_cls = cfg.model.head.num_classes

    def lap(key: str, t0: float) -> float:
        if timings is not None:
            if key == "step_ms" and det.device.type == "cuda":
                torch.cuda.synchronize(det.device)
            timings.setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    prefetcher = Prefetcher(iter(loader))
    try:
        for bi, batch in enumerate(prefetcher):
            if max_batches is not None and bi >= max_batches:
                break
            t0 = time.perf_counter()
            while True:
                hb = harvest_frames(batch, M, cfg.model.head.max_gt,
                                    cfg.model.backbone.in_res_hw,
                                    fold_hw=stem_fold_hw(cfg.model))
                if not hb["dropped_frames"]:
                    break
                # dropped eval frames would silently bias mAP (the
                # reference harvests ragged and can never drop,
                # modules/utils/detection.py:27-58): regrow the static
                # budget to this batch's demand and re-harvest
                M = int(hb["max_slot_frames"])
                print(f"eval harvest budget grown to {M}/slot", flush=True)
            t0 = lap("harvest_ms", t0)
            states, preds = eval_step(states, hb)
            t0 = lap("step_ms", t0)
            if hb["num_frames"] == 0:
                continue
            dets, valid = postprocess(preds, num_classes=n_cls,
                                      conf_threshold=conf,
                                      nms_threshold=pp.nms_threshold,
                                      pre_topk=pp.pre_nms_topk,
                                      max_dets=pp.max_dets, plain=plain)
            dets = dets.cpu().numpy()
            valid = valid.cpu().numpy()
            t0 = lap("postprocess_ms", t0)
            # rows are (b, m) flattened with b outer
            Mslot = hb["frame_t"].shape[1]
            for b in range(len(hb["boxes"])):
                for m in range(Mslot):
                    lab = hb["boxes"][b][m]
                    if lab is None:
                        continue
                    row = b * Mslot + m
                    d = dets[row][valid[row]]
                    gt, dt = boxes_to_prophesee(lab, d if len(d) else None)
                    evaluator.add_labels([gt])
                    evaluator.add_predictions([dt])
            lap("bridge_ms", t0)
            if on_batch is not None:
                on_batch(bi, hb, preds, dets, valid)
    finally:
        # join the producer even on an exception path (and on the
        # max_batches early break)
        prefetcher.close()
        for s in seqs:
            s.close()
    t0 = time.perf_counter()
    metrics = evaluator.evaluate()
    if timings is not None:
        timings["evaluate_ms"] = (time.perf_counter() - t0) * 1e3
    return metrics
