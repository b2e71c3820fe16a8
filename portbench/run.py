"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's generator (`generators/<kind>.py`,
named by its traffic file) builds the program's inputs and weights from
the seed, warms up every shape the cell uses (set-up), measures for
`--seconds`, and checks what the timed path produced against the plain
reference (`portbench/reference/`) once the window has closed. With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics and the device's busy and window
seconds. The numbers compared, each beside its limit, come last on
standard error and last in the line. The run exits 1 without a result
where there is no card or fewer cards than the cell asks for, or where
a module of JAX or of the JAX package was loaded.

`--calibrate SEEDS` (comma-separated) measures instead the readings the
limits are set from, for each seed in one process: the program's, the
lower-precision control's and each planted fault's; it prints one JSON
line a seed and no result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the op library builds into `leod_tpu_torch/_build/` by itself)."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", default="",
                    help="comma-separated seeds: print the readings the "
                         "limits are set from instead of a run")
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 1


def result_line(cell, run, correct: bool, rows, trace: int) -> dict:
    from portbench.bench import read_metric
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(cell, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(run.device)
    device["memory_peak_bytes"] = int(run.memory_peak_bytes)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        w = run.trace.get("window")
        if w is not None:
            device["busy_s"] = w.busy_s()
            device["window_s"] = w.wall_s
            out["breakdown"] = {"device_ops": w.top_ops(),
                                "idle_gaps": w.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    _caches(ROOT)
    from portbench import bench
    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        return fail("no BENCHMARK.json beside portbench/")
    try:
        cell = bench.find_cell(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(f"cell {args.workload!r}: {e}")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    drv = bench.generator(cell)
    if args.calibrate:
        for s in (int(x) for x in args.calibrate.split(",")):
            readings = drv.calibrate(cell, s, "cuda", args.seconds)
            print(json.dumps({"seed": s, **readings}), flush=True)
        return 0
    run = drv.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  bench.Clock(T_START))
    run.device.update({"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips})
    bad = bench.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {bad}")
    correct, rows = bench.judge(run, cell.limits)
    line = result_line(cell, run, correct, rows, args.trace)
    for n, v, lim in rows:
        print(f"check {n}: {v!r} limit {lim!r}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
