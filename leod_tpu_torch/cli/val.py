"""Streaming evaluation CLI (port of `cli/val.py`; reference entry point:
val.py).

    python -m leod_tpu_torch.cli.val --dataset gen1 --path ./datasets/gen1 --ckpt runs/x/ckpt_best
    python -m leod_tpu_torch.cli.val --synthetic --size tiny --ckpt runs/smoke/ckpt_last --cpu

Streams the split through the block, ConvLSTM and NMS kernels
(`run_streaming_eval`; `--tta`: `run_tta_eval` with h-flip and t-flip)
and prints the COCO metrics as JSON. `--ckpt` takes the port's
checkpoint (`runs/<exp>/ckpt_last` or the .pt file), `--torch-ckpt` a
reference LEOD/RVT PyTorch .ckpt/.pth; with neither the weights are
made from seed 0.

`main(argv, frames=...)`: the event frames from an in-memory frame store
(`leod_tpu_torch/cli/__init__.py`); `--synthetic` renders one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

from ..config import ExperimentConfig, derive, experiment_preset
from ..eval.tta import run_tta_eval
from ..train.trainer import run_streaming_eval
from ._common import (Frames, device_of, dtype_of, load_detector, open_split,
                      ratio_of, synthetic_frames)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.val")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--path", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--ckpt", default=None, help="the port's checkpoint")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt/.pth to convert and load")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--conf", type=float, default=0.001,
                    help="final-eval confidence threshold")
    ap.add_argument("--reverse", action="store_true",
                    help="evaluate time-reversed sequences")
    ap.add_argument("--eval-ratio", type=float, default=-1.0,
                    help="every-k subsample of the eval split")
    ap.add_argument("--tta", action="store_true",
                    help="h-flip + t-flip test-time augmentation")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--fp32", action="store_true")
    return ap


def build_config(args, path: Optional[str]) -> ExperimentConfig:
    """`cli/val.py:55-72`."""
    cfg = experiment_preset(args.dataset, args.size)
    dst = cfg.dataset
    if path:
        dst = dataclasses.replace(dst, path=path)
    if args.seq_len:
        dst = dataclasses.replace(dst, sequence_length=args.seq_len)
    if args.eval_ratio > 0:
        dst = dataclasses.replace(dst, val_ratio=args.eval_ratio,
                                  test_ratio=args.eval_ratio)
    tr = cfg.training
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size_eval=args.batch_size)
    return derive(dataclasses.replace(cfg, dataset=dst, training=tr))


def main(argv: Optional[List[str]] = None, *,
         frames: Frames = None) -> Optional[Dict[str, float]]:
    """Evaluate as the flags say; prints and returns the metrics."""
    args = build_parser().parse_args(argv)
    path = args.path
    if args.synthetic and frames is None:
        path, frames = synthetic_frames(args.path)
    cfg = build_config(args, path)
    dev = device_of(args)
    det = load_detector(cfg.model, dtype_of(args), dev, args.ckpt,
                        args.torch_ckpt)
    seqs = open_split(cfg.dataset, args.split, frames,
                      seq_ratio=ratio_of(cfg.dataset, args.split))
    if args.tta:
        metrics = run_tta_eval(det, cfg, split=args.split,
                               conf_threshold=args.conf, sequences=seqs,
                               device=dev)
    else:
        metrics = run_streaming_eval(det, cfg, split=args.split,
                                     conf_threshold=args.conf,
                                     time_flip=args.reverse, sequences=seqs,
                                     device=dev)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
