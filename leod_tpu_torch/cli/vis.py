"""Visualization CLI (port of `cli/vis.py`; reference entry point:
vis_pred.py).

    python -m leod_tpu_torch.cli.vis --dataset gen1 --path ./datasets/gen1 --ckpt runs/x/ckpt_best --out ./vis_out
    python -m leod_tpu_torch.cli.vis --synthetic --size tiny --out /tmp/vis --num-seqs 1 --reverse --cpu --fp32

Streams sequences through the block, ConvLSTM and NMS kernels (the eval
step, `train/step.py` `make_eval_step`, one stream slot) and writes an
MP4 a sequence with the predictions above `--conf` (green, labelled
class:score), those between `--show-conf` and `--conf` (red) and the GT
(black) drawn over the rendered event frames (`utils/viz.py`).
`--reverse` also runs each sequence time-reversed from a fresh state,
plays that back forwards and writes <name>_both.mp4, normal | reversed
side by side with a 4 px white bar between (2w + 4 wide; reference:
vis_pred.py:239-319). `--ckpt` takes the port's checkpoint
(`runs/<exp>/ckpt_last` or the .pt file), `--torch-ckpt` a reference
LEOD/RVT PyTorch .ckpt/.pth; with neither the weights are made from
seed 0. cv2 writes the videos.

`main(argv, frames=...)`: the event frames from an in-memory frame store
(`leod_tpu_torch/cli/__init__.py`); `--synthetic` renders the JAX CLI's
synthetic split (2 train, 1 val, 1 test sequences of 64 reprs) as one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config import ExperimentConfig, derive, experiment_preset, stem_fold_hw
from ..data.loader import collate, harvest_frames, open_split_sequences
from ..data.sequence import EventSequence, WindowedSequence
from ..data.synthetic import render_dataset_frames
from ..models.detector import Detector
from ..ops.nms import postprocess
from ..train.step import make_eval_step
from ..utils.viz import draw_boxes, render_event_frame
from ._common import Frames, device_of, dtype_of, load_detector, open_split

GREEN, RED, BLACK = (0, 200, 0), (0, 0, 255), (0, 0, 0)
PAD = 4         # the white bar between the halves of a _both video


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.vis")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--path", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--split", default="test")
    ap.add_argument("--ckpt", default=None, help="the port's checkpoint")
    ap.add_argument("--torch-ckpt", default=None,
                    help="reference PyTorch .ckpt/.pth to convert and load")
    ap.add_argument("--out", default="./vis_out")
    ap.add_argument("--num-seqs", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--conf", type=float, default=0.1)
    ap.add_argument("--show-conf", type=float, default=0.01,
                    help="draw boxes above this in red (filtered-out)")
    ap.add_argument("--fps", type=int, default=20)
    ap.add_argument("--reverse", action="store_true",
                    help="also run each sequence TIME-REVERSED and write a "
                         "side-by-side <name>_both.mp4 (normal | reversed "
                         "played back forwards) — reference "
                         "vis_pred.py:239-319")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--fp32", action="store_true")
    return ap


def build_config(args, path: Optional[str]) -> ExperimentConfig:
    """`cli/vis.py:61-72`: the preset at `--seq-len`, on `path`."""
    cfg = experiment_preset(args.dataset, args.size)
    dst = cfg.dataset
    if path:
        dst = dataclasses.replace(dst, path=path)
    dst = dataclasses.replace(dst, sequence_length=args.seq_len)
    return derive(dataclasses.replace(cfg, dataset=dst))


def render_sequence(det: Detector, cfg: ExperimentConfig,
                    seq: EventSequence, eval_step: Callable, conf: float,
                    show_conf: float, time_flip: bool = False) -> dict:
    """Stream one sequence (time-reversed with `time_flip`) through the
    eval step, one slot from zero states, a window of L frames at a
    time; NMS at `show_conf`. Returns {"frames": the drawn BGR frames,
    "dets": each frame's detections above `show_conf` [n, 7]} (padded
    frames skipped, in stream order)."""
    L = cfg.dataset.sequence_length
    mc = cfg.model
    pp = mc.postprocess
    win = WindowedSequence(seq, L, start_from_zero=True, time_flip=time_flip)
    states = det.init_states(1)
    frames, kept = [], []
    for i in range(len(win)):
        batch = collate([win[i]])
        hb = harvest_frames(batch, L, mc.head.max_gt, mc.backbone.in_res_hw,
                            fold_hw=stem_fold_hw(mc))
        hb["frame_t"] = np.arange(L, dtype=np.int32)[None]
        hb["frame_mask"] = np.ones((1, L), bool)
        states, preds = eval_step(states, hb)
        dets, valid = postprocess(
            preds, num_classes=mc.head.num_classes,
            conf_threshold=show_conf, nms_threshold=pp.nms_threshold,
            pre_topk=pp.pre_nms_topk, max_dets=pp.max_dets)
        dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
        for t in range(L):
            if batch["is_padded"][0, t]:
                continue
            img = render_event_frame(batch["ev"][t, 0])
            d = dets[t][valid[t]]
            score = d[:, 4] * d[:, 5]
            strong, weak = d[score >= conf], d[score < conf]
            draw_boxes(img, weak, RED)
            draw_boxes(img, strong, GREEN,
                       [f"{int(b[6])}:{b[4] * b[5]:.2f}" for b in strong])
            gt = batch["labels"][t][0]
            if gt is not None:
                draw_boxes(img, gt.xyxy(), BLACK)
            frames.append(img)
            kept.append(d)
    return {"frames": frames, "dets": kept}


def side_by_side(frames: List[np.ndarray],
                 rev: List[np.ndarray]) -> List[np.ndarray]:
    """normal | reversed (played back forwards), a PAD px white bar
    between: even, so mp4v keeps the width (it rounds odd ones)."""
    rev = rev[::-1]
    n = min(len(frames), len(rev))
    if not n:
        return []
    pad = np.full((frames[0].shape[0], PAD, 3), 255, np.uint8)
    return [np.concatenate([a, pad, b], axis=1)
            for a, b in zip(frames[:n], rev[:n])]


def write_video(path: str, frames: List[np.ndarray], fps: int) -> None:
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for img in frames:
        vw.write(img)
    vw.release()
    print(f"wrote {path}", flush=True)


def main(argv: Optional[List[str]] = None, *,
         frames: Frames = None) -> Dict[str, dict]:
    """Write the videos the flags ask for; returns {video path:
    {"frames": its frame count, "dets": each frame's detections above
    `--show-conf` (None for a _both video)}}."""
    args = build_parser().parse_args(argv)
    path = args.path
    if args.synthetic and frames is None:
        path = path or tempfile.mkdtemp(prefix="leod_synth_")
        frames = render_dataset_frames(path, num_train=2, num_val=1,
                                       num_test=1, num_reprs=64)
    cfg = build_config(args, path)
    dev = device_of(args)
    det = load_detector(cfg.model, dtype_of(args), dev, args.ckpt,
                        args.torch_ckpt)
    eval_step = make_eval_step(det, device=dev)
    seqs = open_split(cfg.dataset, args.split, frames)
    if seqs is None:
        seqs = open_split_sequences(cfg.dataset, args.split)
    os.makedirs(args.out, exist_ok=True)
    written: Dict[str, dict] = {}
    for seq in seqs[:args.num_seqs]:
        name = os.path.basename(seq.seq_dir)
        fwd = render_sequence(det, cfg, seq, eval_step, args.conf,
                              args.show_conf)
        if fwd["frames"]:
            out = os.path.join(args.out, f"{name}.mp4")
            write_video(out, fwd["frames"], args.fps)
            written[out] = {"frames": len(fwd["frames"]), "dets": fwd["dets"]}
        if args.reverse:
            rev = render_sequence(det, cfg, seq, eval_step, args.conf,
                                  args.show_conf, time_flip=True)
            both = side_by_side(fwd["frames"], rev["frames"])
            if both:
                out = os.path.join(args.out, f"{name}_both.mp4")
                write_video(out, both, args.fps)
                written[out] = {"frames": len(both), "dets": None}
    for seq in seqs:
        seq.close()
    return written


if __name__ == "__main__":
    main()
