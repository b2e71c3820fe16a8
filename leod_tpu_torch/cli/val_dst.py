"""Score a generated pseudo dataset against the withheld GT (port of
`cli/val_dst.py`; reference entry point: val_dst.py). Host only.

    python -m leod_tpu_torch.cli.val_dst --dataset gen1 --orig-path ./datasets/gen1 \\
        --path ./datasets/pseudo/gen1_x0.05_ss --ratio 0.05

`main(argv, frames=...)`: the original split's event frames from an
in-memory frame store (`leod_tpu_torch/cli/__init__.py`) instead of its
h5 files.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

from ..config import broadcast_gen4_thresholds, dataset_preset
from ..selftrain.pseudo_labeler import PseudoLabelConfig
from ..selftrain.verify import score_pseudo_dataset, verify_pseudo_dataset
from ._common import Frames, open_split


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.val_dst")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--path", required=True, help="pseudo dataset root")
    ap.add_argument("--orig-path", required=True, help="original dataset root")
    ap.add_argument("--ratio", type=float, default=-1.0)
    ap.add_argument("--train-ratio", type=float, default=-1.0)
    ap.add_argument("--obj-thresh", type=float, nargs="+", default=[0.6, 0.3])
    ap.add_argument("--cls-thresh", type=float, nargs="+", default=[0.6, 0.3])
    ap.add_argument("--verify", action="store_true",
                    help="also verify structural integrity on all sequences")
    return ap


def main(argv: Optional[List[str]] = None, *,
         frames: Frames = None) -> Dict[str, float]:
    """Verify (under --verify) and score; prints and returns the score."""
    args = build_parser().parse_args(argv)
    dst = dataclasses.replace(dataset_preset(args.dataset),
                              path=args.orig_path, ratio=args.ratio,
                              train_ratio=args.train_ratio)
    obj_t = broadcast_gen4_thresholds(tuple(args.obj_thresh), args.dataset)
    cls_t = broadcast_gen4_thresholds(tuple(args.cls_thresh), args.dataset)
    pl_cfg = PseudoLabelConfig(obj_thresh=obj_t, cls_thresh=cls_t)
    sources = open_split(dst, "train", frames, label_ratio=dst.ratio)
    if args.verify:
        n = verify_pseudo_dataset(args.path, dst, sample_frac=1.0,
                                  sequences=sources)
        print(f"verified {n} sequences: OK")
    metrics = score_pseudo_dataset(args.path, dst, pl_cfg, dst.num_classes,
                                   dst.classes, sequences=sources)
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()
