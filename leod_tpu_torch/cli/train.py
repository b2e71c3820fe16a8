"""Train CLI (port of `cli/train.py`; reference entry point: train.py).

    python -m leod_tpu_torch.cli.train --dataset gen1 --size base --path ./datasets/gen1
    python -m leod_tpu_torch.cli.train --synthetic --size tiny --steps 50 --cpu

Every flag of the JAX CLI maps to the same `ExperimentConfig`; `--mesh`
raises (multi-device, ROADMAP.md A.5). Pred-vs-GT panels go into
<run_dir>/viz/ every `training.viz_every_steps` (the preset's 5000).
Checkpoints are the port's `ckpt_<name>.pt` files (`--checkpoint` and
`--weight` take `runs/<exp>/ckpt_last` or the file itself); an orbax
directory raises. `--torch-weight` takes a reference LEOD/RVT PyTorch
.ckpt/.pth.

`main(argv, frames=...)`: the dataset's event frames from an in-memory
frame store instead of h5 files (`leod_tpu_torch/cli/__init__.py`);
`--synthetic` renders one from `--seed`.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from ..config import ExperimentConfig, derive, experiment_preset
from ..convert import load_reference_checkpoint
from ..train.trainer import MetricLogger, Trainer
from ._common import (Frames, device_of, dtype_of, open_split, ratio_of,
                      synthetic_frames)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.train")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--path", default=None, help="dataset root")
    ap.add_argument("--synthetic", action="store_true",
                    help="render a tiny synthetic dataset and train on it")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warmup-pct", type=float, default=None,
                    help="OneCycle warmup fraction (default 0.005)")
    ap.add_argument("--sampling", default=None,
                    choices=["random", "stream", "mixed"])
    ap.add_argument("--ratio", type=float, default=-1.0,
                    help="WSOD label-frequency subsample ratio")
    ap.add_argument("--tflip", action="store_true",
                    help="temporal-flip augmentation (prob 0.5 on both "
                         "samplers)")
    ap.add_argument("--train-ratio", type=float, default=-1.0,
                    help="SSOD sequence subsample ratio")
    ap.add_argument("--soft", action="store_true",
                    help="self-training student config (ignore_bbox_thresh)")
    ap.add_argument("--ssod-online", action="store_true",
                    help="online SSOD: an EMA teacher on weak views "
                         "pseudo-labels strong views in the loop")
    ap.add_argument("--ssod-alpha", type=float, default=0.999,
                    help="EMA decay for the online teacher")
    ap.add_argument("--ssod-burn-in", type=int, default=0,
                    help="GT-only steps before pseudo labels merge")
    ap.add_argument("--ssod-thresh", type=float, nargs=2, default=(0.7, 0.7),
                    metavar=("OBJ", "CLS"),
                    help="teacher obj/cls confidence thresholds")
    ap.add_argument("--ssod-update", default="ema",
                    help="teacher update: 'ema' or 'every-N'")
    ap.add_argument("--save-dir", default="./runs")
    ap.add_argument("--exp-name", default="leod_tpu")
    ap.add_argument("--val-every", type=int, default=None)
    ap.add_argument("--ckpt-every-min", type=float, default=None,
                    help="time-triggered checkpoint cadence in minutes "
                         "(default 18); fit() always writes ckpt_last at "
                         "the end")
    ap.add_argument("--max-det-frames", type=int, default=None,
                    help="per-slot labeled-frame harvest budget")
    ap.add_argument("--weight", default=None,
                    help="weight-only init from the port's checkpoint")
    ap.add_argument("--torch-weight", default=None,
                    help="reference PyTorch .ckpt/.pth to convert for "
                         "weight-only init")
    ap.add_argument("--checkpoint", default=None, help="full-state resume")
    ap.add_argument("--auto-resume", action="store_true",
                    help="resume from the newest checkpoint in the run dir")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="trace N steps from step 5 with torch.profiler")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="DP[xSP[xTP]]",
                    help="device mesh (not ported: ROADMAP.md A.5)")
    ap.add_argument("--wandb-project", default=None,
                    help="also stream metrics to WandB (needs the wandb "
                         "package)")
    ap.add_argument("--gradflow", action="store_true",
                    help="log every parameter's mean |grad| at each log "
                         "step")
    return ap


def build_config(args, path: Optional[str]) -> ExperimentConfig:
    """`cli/train.py:99-160`: the preset with the flags applied; `path`
    is the dataset root (--path, or the synthetic split's)."""
    cfg = experiment_preset(args.dataset, args.size, soft=args.soft)
    dst = cfg.dataset
    if path:
        dst = dataclasses.replace(dst, path=path)
    if args.seq_len:
        dst = dataclasses.replace(dst, sequence_length=args.seq_len)
    if args.sampling:
        dst = dataclasses.replace(dst, train_sampling=args.sampling)
    dst = dataclasses.replace(dst, ratio=args.ratio,
                              train_ratio=args.train_ratio)
    if args.tflip:
        dst = dataclasses.replace(
            dst,
            augment_random=dataclasses.replace(dst.augment_random,
                                               prob_tflip=0.5),
            augment_stream=dataclasses.replace(dst.augment_stream,
                                               prob_tflip=0.5))
    tr = cfg.training
    if args.steps:
        tr = dataclasses.replace(tr, max_steps=args.steps)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size_train=args.batch_size,
                                 batch_size_eval=args.batch_size)
    if args.lr:
        tr = dataclasses.replace(tr, learning_rate=args.lr)
    if args.warmup_pct is not None:
        tr = dataclasses.replace(tr, lr_scheduler=dataclasses.replace(
            tr.lr_scheduler, pct_start=args.warmup_pct))
    if args.val_every is not None:
        tr = dataclasses.replace(tr, val_check_interval=args.val_every)
    if args.ckpt_every_min is not None:
        tr = dataclasses.replace(tr, ckpt_every_min=args.ckpt_every_min)
    if args.gradflow:
        tr = dataclasses.replace(tr, gradflow=True)
    if args.max_det_frames is not None:
        tr = dataclasses.replace(tr, max_det_frames=args.max_det_frames)
    elif args.soft and cfg.model.use_label_every <= 1:
        # a student on a dense pseudo dataset is supervised on every
        # frame (reference: modules/detection.py:184-234), so the static
        # harvest budget covers the whole window
        tr = dataclasses.replace(tr, max_det_frames=dst.sequence_length)
    if args.ssod_online:
        tr = dataclasses.replace(tr, ssod_online=dataclasses.replace(
            tr.ssod_online, enabled=True, alpha=args.ssod_alpha,
            update_method=args.ssod_update,
            burn_in_steps=args.ssod_burn_in,
            obj_thresh=args.ssod_thresh[0], cls_thresh=args.ssod_thresh[1]))
    return derive(dataclasses.replace(cfg, dataset=dst, training=tr,
                                      save_dir=args.save_dir,
                                      exp_name=args.exp_name))


def main(argv: Optional[List[str]] = None, *, frames: Frames = None):
    """Train as the flags say; returns the final `TrainState`."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh!r}: multi-device training is not ported yet "
            f"(ROADMAP.md A.5, multi-device); the port trains on one card")
    path = args.path
    if args.synthetic and frames is None:
        path, frames = synthetic_frames(args.path, args.seed, announce=True)
    cfg = build_config(args, path)
    dst, tr = cfg.dataset, cfg.training

    trainer = Trainer(cfg, dtype=dtype_of(args), device=device_of(args))
    if args.wandb_project:
        try:
            trainer.logger.add_sink(MetricLogger.wandb_sink(
                args.wandb_project, run_name=args.exp_name,
                config={"dataset": args.dataset, "size": args.size}))
        except ImportError:
            print("wandb not installed; continuing with JSONL metrics only")
    # the resume chain of cli/train.py:183-217, on one template state
    state = None
    base = (trainer.init_state(tr.batch_size_train, args.seed)
            if (args.auto_resume or args.checkpoint or args.weight
                or args.torch_weight) else None)
    if args.auto_resume and not args.checkpoint:
        state, latest = trainer.restore_latest(base)
        if latest:
            print(f"auto-resumed from {latest}")
        else:
            state = None
    if state is None and args.checkpoint:
        state = trainer.restore_checkpoint(args.checkpoint, base)
    elif state is None and args.weight:
        state = trainer.load_weights(args.weight, base)
    elif state is None and args.torch_weight:
        load_reference_checkpoint(trainer.det, args.torch_weight)
        state = base
    elif state is None:
        state = base
    final = trainer.fit(
        seed=args.seed, state=state, profile_steps=args.profile_steps,
        sequences=open_split(dst, "train", frames,
                             seq_ratio=dst.train_ratio),
        val_sequences=open_split(dst, "val", frames,
                                 seq_ratio=ratio_of(dst, "val")))
    trainer.close()
    print(f"done at step {int(final.step)}")
    return final


if __name__ == "__main__":
    main()
