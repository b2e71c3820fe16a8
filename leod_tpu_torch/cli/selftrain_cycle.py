"""LEOD's self-training cycle end to end on synthetic Gen1-format data
(port of `tools/selftrain_cycle.sh`; reference workflow:
docs/benchmark.md:58-141): a WSOD teacher, pseudo-label generation with
TTA and tracking, the soft student, and their evaluations.

    python -m leod_tpu_torch.cli.selftrain_cycle runs/cycle --size base
    python -m leod_tpu_torch.cli.selftrain_cycle runs/cycle --size tiny --cpu \\
        --steps-teacher 2 --steps-student 2 --seq-len 5

Stages, each through a CLI's `main` in this one process:
  0. the synthetic split: 6 train and 4 val sequences, 0 test, 64 reprs,
     labels every 2 reprs from repr 11 (`data/synthetic.py`
     `render_dataset_frames`, seed 0). The label and index files go to
     <workdir>/data; the event frames stay in memory (a machine may lack
     `h5py`) and reach every stage as its `frames=`;
  1. the WSOD teacher at label ratio 0.25 (`cli.train`);
  2. its evaluation on val (`cli.val`) -> teacher_eval.json;
  3. pseudo labels in 2 shards into one dir, h-flip TTA (`cli.predict`);
  4. the merged pseudo dataset verified and scored against the withheld
     GT (`cli.val_dst`) -> pseudo_score.json;
  5. the soft student from the teacher's weights (`cli.train --soft`);
  6. its evaluation on val -> student_eval.json.

`--resume` keeps the workdir: a stage whose `.done_N` marker exists is
skipped, and an interrupted train stage continues from its newest
checkpoint (`--auto-resume`). Each stage's wall seconds go to
stage_seconds.json. `--cpu` and `--fp32` pass on to every stage that
runs the model.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, List, Optional

from ..data.synthetic import render_dataset_frames
from . import predict, train, val, val_dst
from ._common import dump_json

STAGES = ("synthetic dataset", "WSOD teacher", "teacher eval",
          "pseudo-label generation", "pseudo-dataset score", "soft student",
          "student eval")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m leod_tpu_torch.cli.selftrain_cycle")
    ap.add_argument("workdir", nargs="?", default="runs/selftrain_cycle")
    ap.add_argument("--steps-teacher", type=int, default=300)
    ap.add_argument("--steps-student", type=int, default=300)
    ap.add_argument("--num-train", type=int, default=6,
                    help="synthetic train sequences")
    ap.add_argument("--num-reprs", type=int, default=64,
                    help="event reprs per sequence")
    ap.add_argument("--label-every", type=int, default=2,
                    help="labeled-frame spacing (before the WSOD subsample)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=21)
    ap.add_argument("--size", default="tiny", choices=["tiny", "small", "base"])
    ap.add_argument("--ckpt-min", type=float, default=600,
                    help="timed mid-run checkpoint cadence, minutes")
    ap.add_argument("--resume", action="store_true",
                    help="keep the workdir and skip the stages marked done")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--fp32", action="store_true",
                    help="compute in fp32 (bf16 is slow on the CPU)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the stages not yet done; returns {"seconds": {stage: s},
    "teacher_eval", "pseudo_score", "student_eval": the JSON written}."""
    args = build_parser().parse_args(argv)
    work = args.workdir
    if args.resume:
        os.makedirs(work, exist_ok=True)
        done = sorted(f for f in os.listdir(work) if f.startswith(".done_"))
        print(f"resuming cycle in {work} (done: {' '.join(done)})")
    else:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
    data, pseudo = os.path.join(work, "data"), os.path.join(work, "pseudo")
    runs = os.path.join(work, "runs")
    size = ["--dataset", "gen1", "--size", args.size]
    cpu = (["--cpu"] if args.cpu else []) + (["--fp32"] if args.fp32 else [])
    shape = ["--batch-size", str(args.batch), "--seq-len", str(args.seq_len)]
    train_extra = (["--ckpt-every-min", str(args.ckpt_min), "--auto-resume",
                    "--save-dir", runs, "--val-every", "0"] + cpu)
    teacher_ckpt = os.path.join(runs, "teacher", "ckpt_last")
    student_ckpt = os.path.join(runs, "student", "ckpt_last")
    secs_path = os.path.join(work, "stage_seconds.json")
    seconds: Dict[str, float] = {}
    if os.path.exists(secs_path):
        with open(secs_path) as f:
            seconds = json.load(f)

    def stage(n: int, fn) -> None:
        marker = os.path.join(work, f".done_{n}")
        if os.path.exists(marker):
            print(f"== {n}. {STAGES[n]} == (done, skip)", flush=True)
            return
        print(f"== {n}. {STAGES[n]} ==", flush=True)
        t0 = time.perf_counter()
        fn()
        seconds[f"{n}. {STAGES[n]}"] = time.perf_counter() - t0
        dump_json(secs_path, seconds)
        open(marker, "w").close()

    # the frames are rendered in every invocation (they are never on
    # disk); the label files only where they are missing
    frames = {}

    def stage0():
        frames.update(render_dataset_frames(
            data, num_train=args.num_train, num_val=4, num_test=0,
            num_reprs=args.num_reprs, label_every=args.label_every,
            first_label_repr=11))
        print("dataset at", data)

    stage(0, stage0)
    if not frames:
        stage0()
    stage(1, lambda: train.main(
        size + ["--path", data, "--ratio", "0.25",
                "--steps", str(args.steps_teacher)] + shape
        + ["--exp-name", "teacher"] + train_extra, frames=frames))
    stage(2, lambda: dump_json(os.path.join(work, "teacher_eval.json"),
                               val.main(size + ["--path", data, "--split",
                                                "val", "--seq-len",
                                                str(args.seq_len), "--ckpt",
                                                teacher_ckpt] + cpu,
                                        frames=frames)))

    def stage3():
        # a re-run after an interruption regenerates both shards
        shutil.rmtree(pseudo, ignore_errors=True)
        for shard in (0, 1):
            predict.main(size + [
                "--path", data, "--ratio", "0.25", "--ckpt", teacher_ckpt,
                "--save-dir", pseudo, "--seq-len", str(args.seq_len),
                "--batch-size", "3", "--tta-hflip",
                "--obj-thresh", "0.3", "0.15", "--cls-thresh", "0.3", "0.15",
                "--min-track-len", "3", "--conf", "0.05",
                "--shard-index", str(shard), "--num-shards", "2"] + cpu,
                frames=frames)

    stage(3, stage3)
    stage(4, lambda: dump_json(os.path.join(work, "pseudo_score.json"),
                               val_dst.main(["--dataset", "gen1", "--path",
                                             pseudo, "--orig-path", data,
                                             "--ratio", "0.25", "--verify"],
                                            frames=frames)))
    stage(5, lambda: train.main(
        size + ["--path", pseudo, "--soft", "--weight", teacher_ckpt,
                "--steps", str(args.steps_student)] + shape
        + ["--lr", "5e-4", "--exp-name", "student"] + train_extra,
        frames=frames))
    stage(6, lambda: dump_json(os.path.join(work, "student_eval.json"),
                               val.main(size + ["--path", data, "--split",
                                                "val", "--seq-len",
                                                str(args.seq_len), "--ckpt",
                                                student_ckpt] + cpu,
                                        frames=frames)))
    print(f"cycle complete: teacher/student eval JSON + pseudo score in "
          f"{work}")
    out: Dict[str, object] = {"seconds": seconds}
    for name in ("teacher_eval", "pseudo_score", "student_eval"):
        with open(os.path.join(work, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


if __name__ == "__main__":
    main()
