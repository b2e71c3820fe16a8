"""Import raw Prophesee recordings into a training-ready dataset (port
of `cli/import_raw.py`).

Voxelizes `.dat`/`.npy` event recordings (+`<name>_bbox.npy` labels)
into the pre-voxelized layout every loader reads, on the card unless
`--cpu` (`data/import_raw.py` has the format contract):

    # Gen1 (304x240), histograms at full resolution
    python -m leod_tpu_torch.cli.import_raw --raw-dir ~/gen1/train_raw --out ~/gen1_ds --split train

    # 1Mpx (1280x720), _ds2_nearest layout + 7->3 class remap
    python -m leod_tpu_torch.cli.import_raw --raw-dir ~/1mpx/train_raw --out ~/1mpx_ds \\
        --split train --height 720 --width 1280 --ds2 --class-map 0:0,1:1,2:2

`main(argv, frames=...)`: the event frames go into an in-memory frame
store (`leod_tpu_torch/cli/__init__.py`) instead of h5 files; the label
and index files are written under `--out` either way.
"""
from __future__ import annotations

import argparse
from typing import List, MutableMapping, Optional

import numpy as np

from ..data.import_raw import _parse_class_map, import_split
from ._common import device_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.import_raw",
                                 description=__doc__)
    ap.add_argument("--raw-dir", required=True,
                    help="directory of raw recordings (events + _bbox.npy)")
    ap.add_argument("--out", required=True, help="dataset root to write")
    ap.add_argument("--split", default="train",
                    choices=("train", "val", "test"))
    ap.add_argument("--height", type=int, default=240,
                    help="sensor height (overridden by .dat headers)")
    ap.add_argument("--width", type=int, default=304)
    ap.add_argument("--bins", type=int, default=10)
    ap.add_argument("--dt-ms", type=int, default=50)
    ap.add_argument("--ds2", action="store_true",
                    help="write the _ds2_nearest half-resolution layout "
                         "(1Mpx convention); labels stay full-res")
    ap.add_argument("--batch", type=int, default=16,
                    help="windows voxelized per device call")
    ap.add_argument("--class-map", default=None,
                    help="raw->dataset class remap, e.g. 0:0,1:1,2:2 "
                         "(unmapped classes are dropped)")
    ap.add_argument("--cpu", action="store_true", help="voxelize on the CPU")
    return ap


def main(argv: Optional[List[str]] = None, *,
         frames: Optional[MutableMapping[str, np.ndarray]] = None) -> int:
    """Import as the flags say; returns the number of sequences."""
    args = build_parser().parse_args(argv)
    n = import_split(args.raw_dir, args.out, args.split,
                     height=args.height, width=args.width, bins=args.bins,
                     dt_us=args.dt_ms * 1000, ds2=args.ds2,
                     batch=args.batch,
                     class_map=_parse_class_map(args.class_map),
                     frames=frames, device=device_of(args))
    print(f"imported {n} sequences into {args.out}/{args.split}")
    return n


if __name__ == "__main__":
    main()
