"""Pseudo-label dataset generation CLI (port of `cli/predict.py`;
reference entry point: predict.py).

Runs the teacher over the training split through the block, ConvLSTM
and NMS kernels (`PseudoLabelRunner`, h-flip TTA in the batch and a
time-flipped second pass where asked), writes a new pseudo-labeled
dataset, verifies its structure, and scores the generated labels
against the withheld GT.

    python -m leod_tpu_torch.cli.predict --dataset gen1 --path ./datasets/gen1 \\
        --ckpt runs/teacher/ckpt_best --ratio 0.05 \\
        --save-dir ./datasets/pseudo/gen1_x0.05_ss --tta-hflip --tta-tflip

Shards (`--shard-index`, `--num-shards`) write into one save dir; verify
and score the union once with `leod_tpu_torch.cli.val_dst`.
`--tracking-only` re-runs the track filter over the pseudo dataset at
`--path` without a model.

`main(argv, frames=...)`: the event frames from an in-memory frame store
(`leod_tpu_torch/cli/__init__.py`); `--synthetic` renders one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

from ..config import (ExperimentConfig, broadcast_gen4_thresholds, derive,
                      experiment_preset)
from ..selftrain.pseudo_labeler import PseudoLabelConfig, rerun_track_filter
from ..selftrain.runner import PseudoLabelRunner
from ..selftrain.verify import score_pseudo_dataset, verify_pseudo_dataset
from ._common import (Frames, device_of, dtype_of, load_detector, open_split,
                      synthetic_frames)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.predict")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--path", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--ratio", type=float, default=-1.0,
                    help="WSOD: teacher was trained on labels at this ratio")
    ap.add_argument("--train-ratio", type=float, default=-1.0,
                    help="SSOD: teacher saw this fraction of sequences")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--obj-thresh", type=float, nargs="+", default=[0.6, 0.3])
    ap.add_argument("--cls-thresh", type=float, nargs="+", default=[0.6, 0.3])
    ap.add_argument("--min-track-len", type=int, default=6)
    ap.add_argument("--no-inpaint", action="store_true")
    ap.add_argument("--track-method", default="forward or backward",
                    choices=["forward", "forward or backward"])
    ap.add_argument("--skip-first-t", type=int, default=0)
    ap.add_argument("--tta-hflip", action="store_true")
    ap.add_argument("--tta-tflip", action="store_true")
    ap.add_argument("--no-use-gt", action="store_true")
    ap.add_argument("--tracking-only", action="store_true",
                    help="re-run the track filter over an existing pseudo "
                         "dataset at --path (no model inference)")
    ap.add_argument("--conf", type=float, default=0.1)
    ap.add_argument("--verify-frac", type=float, default=0.1)
    ap.add_argument("--shard-index", type=int, default=0,
                    help="sequence shard this process generates")
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--fp32", action="store_true")
    return ap


def build_config(args, path: Optional[str]):
    """`cli/predict.py:86-115`: (ExperimentConfig, PseudoLabelConfig)."""
    cfg = experiment_preset(args.dataset, args.size)
    dst = cfg.dataset
    if path:
        dst = dataclasses.replace(dst, path=path)
    if args.seq_len:
        dst = dataclasses.replace(dst, sequence_length=args.seq_len)
    dst = dataclasses.replace(dst, ratio=args.ratio,
                              train_ratio=args.train_ratio)
    tr = cfg.training
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size_eval=args.batch_size)
    cfg = derive(dataclasses.replace(cfg, dataset=dst, training=tr))
    obj_t = broadcast_gen4_thresholds(tuple(args.obj_thresh), args.dataset)
    cls_t = broadcast_gen4_thresholds(tuple(args.cls_thresh), args.dataset)
    pl_cfg = PseudoLabelConfig(
        skip_first_t=args.skip_first_t, obj_thresh=obj_t, cls_thresh=cls_t,
        min_track_len=args.min_track_len, track_method=args.track_method,
        inpaint=not args.no_inpaint, tta_hflip=args.tta_hflip,
        tta_tflip=args.tta_tflip, use_gt=not args.no_use_gt)
    pp = dataclasses.replace(cfg.model.postprocess,
                             confidence_threshold=args.conf)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, postprocess=pp))
    return cfg, pl_cfg


def main(argv: Optional[List[str]] = None, *,
         frames: Frames = None) -> Dict[str, Dict[str, float]]:
    """Generate (or re-filter) as the flags say; returns {"teacher": the
    teacher's quality on the withheld GT, "score": the written labels'
    score} ({} where a step did not run)."""
    args = build_parser().parse_args(argv)
    path = args.path
    if args.synthetic and frames is None:
        path, frames = synthetic_frames(args.path)
    cfg: ExperimentConfig
    cfg, pl_cfg = build_config(args, path)
    dst = cfg.dataset

    if args.tracking_only:
        n = rerun_track_filter(dst.path, args.save_dir, dst, pl_cfg,
                               frames=frames)
        print(f"re-filtered {n} sequences into {args.save_dir}")
        return {"teacher": {}, "score": {}}

    det = load_detector(cfg.model, dtype_of(args), device_of(args),
                        args.ckpt)
    runner = PseudoLabelRunner(
        det, cfg, pl_cfg, args.save_dir, shard_index=args.shard_index,
        num_shards=args.num_shards, device=device_of(args),
        sequences=open_split(dst, "train", frames, seq_ratio=dst.train_ratio,
                             label_ratio=dst.ratio, pseudo_mode=True))
    metrics = runner.run()
    print("teacher quality:", json.dumps(metrics, indent=2, default=float))

    if args.num_shards > 1:
        # verification and scoring need the union of all shards
        print(f"shard {args.shard_index}/{args.num_shards} done; verify the "
              f"merged dataset with leod_tpu_torch.cli.val_dst once all "
              f"shards have finished")
        return {"teacher": metrics, "score": {}}
    sources = open_split(dst, "train", frames, label_ratio=dst.ratio)
    n = verify_pseudo_dataset(args.save_dir, dst,
                              sample_frac=args.verify_frac,
                              use_gt=pl_cfg.use_gt, sequences=sources)
    print(f"verified {n} generated sequences: OK")
    score = score_pseudo_dataset(args.save_dir, dst, pl_cfg,
                                 cfg.model.head.num_classes, dst.classes,
                                 sequences=sources)
    print("label-quality vs withheld GT:",
          json.dumps(score, indent=2, default=float))
    return {"teacher": metrics, "score": score}


if __name__ == "__main__":
    main()
