"""The self-training cycle's WSOD teacher from other seeds: stages 0-2 of
`leod_tpu_torch.cli.selftrain_cycle` (its split, the teacher through
`cli.train`, the teacher's `cli.val`) with `--seed N` given to the
teacher's training (the weights' init and the loaders' draws), to read
the spread of the teacher's AP over seeds.

    python experiments/teacher_seeds.py runs/teacher_seeds --size base --seeds 1 2 3
    python experiments/teacher_seeds.py runs/ts --size tiny --cpu --fp32 \\
        --steps 2 --seq-len 4 --batch 2 --num-reprs 16 --seeds 1 2

Each seed runs in a process of its own, all started together (on one
card: the steps are host-bound), after the kernels are built once. Each
writes <workdir>/seed<N>/ (the split's label files, runs/teacher/ with
its checkpoint and metrics.jsonl, teacher_eval.json). The script prints
one JSON line, {"<seed>": {"AP", "AP_50", "AP_75", "train_s", "eval_s",
"wall_s"}}, also written to <workdir>/seeds.json. Times are host-clock
seconds of processes that share the host and the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python experiments/teacher_seeds.py")
    ap.add_argument("workdir")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--size", default="base",
                    choices=["tiny", "small", "base"])
    # the cycle's defaults (`selftrain_cycle.build_parser`)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=21)
    ap.add_argument("--num-reprs", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def run_one(args) -> None:
    """One seed: the cycle's stages 0-2 with `--seed` on the teacher."""
    sys.path.insert(0, ROOT)
    from leod_tpu_torch.cli import train, val
    from leod_tpu_torch.cli._common import dump_json
    from leod_tpu_torch.data.synthetic import render_dataset_frames

    work = os.path.join(args.workdir, f"seed{args.one}")
    data, runs = os.path.join(work, "data"), os.path.join(work, "runs")
    size = ["--dataset", "gen1", "--size", args.size]
    cpu = (["--cpu"] if args.cpu else []) + (["--fp32"] if args.fp32 else [])
    # stage 0 as the cycle renders it (seed 0: the same split for every
    # teacher seed)
    t_start = time.perf_counter()
    frames = render_dataset_frames(
        data, num_train=6, num_val=4, num_test=0, num_reprs=args.num_reprs,
        label_every=2, first_label_repr=11)
    t0 = time.perf_counter()
    train.main(size + ["--path", data, "--ratio", "0.25",
                       "--steps", str(args.steps),
                       "--batch-size", str(args.batch),
                       "--seq-len", str(args.seq_len),
                       "--exp-name", "teacher", "--ckpt-every-min", "600",
                       "--save-dir", runs, "--val-every", "0",
                       "--seed", str(args.one)] + cpu, frames=frames)
    t1 = time.perf_counter()
    m = val.main(size + ["--path", data, "--split", "val", "--seq-len",
                         str(args.seq_len), "--ckpt",
                         os.path.join(runs, "teacher", "ckpt_last")] + cpu,
                 frames=frames)
    dump_json(os.path.join(work, "teacher_eval.json"), m)
    dump_json(os.path.join(work, "seconds.json"),
              {"train_s": t1 - t0, "eval_s": time.perf_counter() - t1,
               "wall_s": time.perf_counter() - t_start})


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.one is not None:
        run_one(args)
        return {}
    os.makedirs(args.workdir, exist_ok=True)
    if not args.cpu:
        sys.path.insert(0, ROOT)
        from leod_tpu_torch.ops import _build
        _build.build_all()
    base = [sys.executable, os.path.abspath(__file__)] + list(
        argv if argv is not None else sys.argv[1:])
    procs, logs = {}, {}
    for seed in args.seeds:
        logs[seed] = open(os.path.join(args.workdir, f"seed{seed}.log"), "w")
        procs[seed] = subprocess.Popen(base + ["--one", str(seed)],
                                       stdout=logs[seed],
                                       stderr=subprocess.STDOUT)
    out, failed = {}, []
    for seed, p in procs.items():
        rc = p.wait()
        logs[seed].close()
        if rc != 0:
            failed.append((seed, rc))
            continue
        work = os.path.join(args.workdir, f"seed{seed}")
        with open(os.path.join(work, "teacher_eval.json")) as f:
            m = json.load(f)
        with open(os.path.join(work, "seconds.json")) as f:
            secs = json.load(f)
        out[str(seed)] = {**{k: m[k] for k in ("AP", "AP_50", "AP_75")},
                          **secs}
    with open(os.path.join(args.workdir, "seeds.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    if failed:
        raise SystemExit(f"seeds failed (seed, exit code): {failed}; logs "
                         f"in {args.workdir}")
    return out


if __name__ == "__main__":
    main()
