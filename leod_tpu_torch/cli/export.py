"""Export a detector to a self-contained serving artifact (port of
`cli/export.py`).

    python -m leod_tpu_torch.cli.export --dataset gen1 --ckpt runs/x/ckpt_best --batch-size 16 --out model_gen1.pt2
    python -m leod_tpu_torch.cli.export --synthetic --size tiny --cpu --fp32 --out /tmp/tiny.pt2

The artifact is a `torch.export` program of the serving step with the
weights inside (`serve.py` `export_serve_step`), written as `<out>` and
a `<out>.json` sidecar. A serving process (`cli/serve.py`) runs it
without the model code or a checkpoint. `--ckpt` takes the port's
checkpoint (`runs/<exp>/ckpt_last` or the .pt file; an orbax directory
raises), `--torch-ckpt` a reference LEOD/RVT PyTorch .ckpt/.pth,
`--synthetic` weights made from seed 0. `--platforms` names the devices
the artifact is for (cuda, its alias gpu, cpu; tpu raises); by default
the device it is exported on, the card unless `--cpu`.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..config import derive, experiment_preset
from ..serve import artifact_meta, export_serve_step, save_artifact
from ._common import device_of, dtype_of, load_detector


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.export")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--ckpt", default=None, help="the port's checkpoint")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt/.pth to convert and export")
    ap.add_argument("--synthetic", action="store_true",
                    help="export weights made from seed 0 (smoke/testing)")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="stream slots the exported program serves")
    ap.add_argument("--conf", type=float, default=None,
                    help="confidence threshold baked into postprocess "
                         "(default: the config's)")
    ap.add_argument("--raw-layout", action="store_true",
                    help="take raw [B,H,W,C] frames instead of the "
                         "host-prefolded space-to-depth layout")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated devices the artifact is for: "
                         "cuda (or gpu), cpu (default: the export's)")
    ap.add_argument("--out", required=True,
                    help="output path (.pt2; writes <out>.json too)")
    ap.add_argument("--cpu", action="store_true", help="export on the CPU")
    ap.add_argument("--fp32", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> str:
    """Export as the flags say; returns the artifact's path."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if not (args.ckpt or args.torch_ckpt or args.synthetic):
        ap.error("need --ckpt, --torch-ckpt, or --synthetic")
    cfg = derive(experiment_preset(args.dataset, args.size))
    det = load_detector(cfg.model, dtype_of(args), device_of(args),
                        args.ckpt, args.torch_ckpt)
    fold = not args.raw_layout
    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    exported = export_serve_step(det, cfg, args.batch_size, fold=fold,
                                 conf_threshold=args.conf,
                                 platforms=platforms)
    save_artifact(exported, args.out,
                  artifact_meta(cfg, args.batch_size, fold, args.conf))
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"exported {args.dataset}/{args.size} B={args.batch_size} "
          f"fold={fold} for {','.join(exported.platforms)} -> {args.out} "
          f"({size_mb:.1f} MB) + .json")
    return args.out


if __name__ == "__main__":
    main()
