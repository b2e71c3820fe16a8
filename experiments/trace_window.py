"""The port's spans and counters on the card: what the benchmark's result
line does not show of them.

    python experiments/trace_window.py cell <workload> <seed> <trace> OUT [SECONDS]
    python experiments/trace_window.py cost OUT
    python experiments/trace_window.py profile OUT

`cell` runs one cell of `portbench/` in this process as `portbench/run.py`
does (`--trace 0` or `1`; `BENCHMARK.json`'s seconds unless SECONDS) and
writes OUT (JSON): the result line; every call of the program's train or
eval step (host start and end, whether a profiler was on, whether the
tracer was on); with `trace toggle`, a `--trace 0` run whose every other
step call runs with the tracer on (the tracing cost, paired within one
window: the step calls' medians on and off); and with `trace 1`,
from the tracer's recording (`leod_tpu_torch/timing.py`): the spans a
step or batch, the share of each unprofiled step's synchronized time
("step_ms") that its four phases cover, the share of the prefetch
thread's time a batch (one "load" start to the next) that "load",
"harvest" and "upload" cover, and the profiled stretch's idle device
gaps put down to the innermost program span open at each gap's middle
on the main thread and on the prefetch thread, placed on the device
trace's timeline through the profiler's `profiling_start_time_ns`.

`cost` times `timing.span` with tracing off and on (ns a span, median
of 5 rounds of 200,000), and `count` and `lap` off.

`profile` runs `Trainer.fit(profile_steps=2)` of RVT-T at 64 x 96 on
synthetic sequences and reads the Chrome trace it writes: the "leod."
events by name and by thread, and whether this torch takes the
profiler's `profile_all_threads`.

Every OUT carries the card's name and power limit (`nvidia-smi`).
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _median(xs):
    return statistics.median(xs) if xs else None


# ---------------------------------------------------------------------------
# cell
# ---------------------------------------------------------------------------

def _step_calls(calls, toggle=False):
    """Wraps the trainer module's step makers: each call of a step they
    make appends (start ns, end ns, profiler on at start, tracer on) to
    `calls`; with `toggle`, every other call runs with the tracer on."""
    import torch.autograd.profiler as profiler

    from leod_tpu_torch import timing
    from leod_tpu_torch.train import trainer as tr_mod

    def wrap(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*args):
                on = profiler._is_profiler_enabled
                with timing.recording(toggle and len(calls) % 2 == 1):
                    traced = timing.tracing()
                    t0 = time.perf_counter_ns()
                    out = step(*args)
                    calls.append((t0, time.perf_counter_ns(), on, traced))
                return out
            return run
        return made
    tr_mod.make_train_step = wrap(tr_mod.make_train_step)
    tr_mod.make_eval_step = wrap(tr_mod.make_eval_step)


def _keep_profiler_clock(stash):
    """Each closed profiled stretch's `profiling_start_time_ns` into
    `stash` (`portbench/trace.py` `Stretch` keeps the events only)."""
    from portbench import trace

    close = trace.Stretch.close

    def kept(self):
        start = self.prof.profiler.profiling_start_time_ns
        w = close(self)
        if w is not None:
            stash.append((start, w))
        return w
    trace.Stretch.close = kept


def call_summary(calls, window_ns):
    """Median host ms of the window's step calls (from `window_ns` on)
    and of the period between call starts, over the calls (and periods)
    with no profiler on."""
    calls = [c for c in calls if c[0] >= window_ns]
    free = [(a, b, tr) for a, b, on, tr in calls if not on]
    periods = [(calls[i + 1][0] - calls[i][0]) / 1e6
               for i in range(len(calls) - 1)
               if not calls[i][2] and not calls[i + 1][2]]
    out = {"calls": len(calls), "unprofiled": len(free),
           "call_ms_median": _median([(b - a) / 1e6 for a, b, _ in free]),
           "call_ms": [(b - a) / 1e6 for a, b, _ in free],
           "period_ms_median": _median(periods), "periods_ms": periods}
    for key, want in (("traced", True), ("untraced", False)):
        ms = [(b - a) / 1e6 for a, b, tr in free if tr == want]
        out[f"call_ms_median_{key}"] = _median(ms)
    return out


def _top(by_index, s):
    while s.parent in by_index:
        s = by_index[s.parent]
    return s


def span_counts(spans):
    """Spans a step or batch: {top span name: median count of spans under
    one top span (itself included)}, per thread."""
    by_index = {s.index: s for s in spans}
    groups = {}
    for s in spans:
        t = _top(by_index, s)
        groups.setdefault((s.thread, t.name, t.index), 0)
        groups[(s.thread, t.name, t.index)] += 1
    out = {}
    for (thread, name, _), n in groups.items():
        out.setdefault(f"{thread}:{name}", []).append(n)
    return {k: _median(v) for k, v in out.items()}


def span_medians(spans):
    """{span name: median ms a batch}: a batch's spans of one name are
    those of one batch id under one parent span, summed; only the
    batches whose spans all opened with the profiler off."""
    groups = {}
    for s in spans:
        groups.setdefault((s.name, s.batch, s.parent), []).append(s)
    ms = {}
    for (name, _, _), g in groups.items():
        if not any(s.profiled for s in g):
            ms.setdefault(name, []).append(sum(s.ms for s in g))
    return {name: _median(v) for name, v in sorted(ms.items())}


def step_cover(spans):
    """For each unprofiled "step_ms" with phases under it: the share of
    its time that "step.forward", "step.loss", "step.backward" and
    "step.optimizer" cover (the rest: the closing synchronize and the
    spans' own gaps)."""
    laps = {s.index: s for s in spans if s.name == "step_ms"
            and not s.profiled}
    phases = {}
    for s in spans:
        if s.name.startswith("step.") and s.parent in laps:
            phases.setdefault(s.parent, []).append(s)
    shares = [sum(p.ms for p in ps) / laps[i].ms
              for i, ps in phases.items() if len(ps) == 4]
    return {"steps": len(shares), "share_median": _median(shares),
            "share_min": min(shares) if shares else None,
            "shares": shares}


def prefetch_cover(spans):
    """For each batch whose "load", "harvest" and "upload" and the next
    batch's "load" opened with no profiler on: their summed ms over the
    prefetch thread's time from the batch's "load" start to the next's,
    less its waits for room in the queue ("prefetch.put")."""
    loads = {s.batch: s for s in spans if s.name == "load"
             and s.parent == -1}
    puts = [s for s in spans if s.name == "prefetch.put"]
    parts = {}
    for s in spans:
        if s.name in ("load", "harvest", "upload") and s.parent == -1:
            parts.setdefault(s.batch, []).append(s)
    shares, put_ms = [], []
    for n, ps in parts.items():
        nxt = loads.get(n + 1)
        if nxt is None or len(ps) != 3 or any(p.profiled for p in ps) \
                or nxt.profiled:
            continue
        a, b = loads[n].start_ns, nxt.start_ns
        put = sum(p.ms for p in puts if a <= p.start_ns < b)
        put_ms.append(put)
        shares.append(sum(p.ms for p in ps) / ((b - a) / 1e6 - put))
    return {"batches": len(shares), "share_median": _median(shares),
            "share_min": min(shares) if shares else None, "shares": shares,
            "put_ms_median": _median(put_ms)}


def idle_by_span(spans, start_ns, window):
    """The stretch's idle device gaps (between the first and the last
    device event), each put down to the innermost span open at its middle
    on the main thread and on the prefetch thread: {"main": {span: s},
    "prefetch": {span: s}, "pairs": {"main | prefetch": s}}."""
    from portbench import trace
    iv = sorted((start_ns + s * 1e3, start_ns + e * 1e3)
                for _, s, e in window.device)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)

    def innermost(thread, t):
        open_ = [(s.end_ns - s.start_ns, s.name) for s in spans
                 if s.thread == thread and s.start_ns <= t <= s.end_ns]
        return min(open_)[1] if open_ else "(none)"
    out = {"main": {}, "prefetch": {}, "pairs": {}}
    for a, b in gaps:
        mid = (a + b) / 2
        m, p = innermost("MainThread", mid), innermost("prefetch", mid)
        for key, name in (("main", m), ("prefetch", p),
                          ("pairs", f"{m} | {p}")):
            out[key][name] = out[key].get(name, 0.0) + (b - a) / 1e9
    for key in out:
        out[key] = dict(sorted(out[key].items(), key=lambda kv: -kv[1]))
    out["idle_s"] = sum((b - a) for a, b in gaps) / 1e9
    out["busy_s"] = trace.busy_us([(s, e) for _, s, e in window.device]) / 1e6
    out["stretch_s"] = window.wall_s
    return out


def cell(workload: str, seed: int, trace_arg: str, out_path: str,
         seconds=None) -> None:
    import torch

    from leod_tpu_torch import timing
    from portbench import bench
    from portbench.run import result_line

    cell_ = bench.find_cell(ROOT, workload)
    traced = trace_arg == "1"
    calls, stash = [], []
    _step_calls(calls, toggle=trace_arg == "toggle")
    _keep_profiler_clock(stash)
    timing.reset()
    if seconds is None:
        seconds = bench.read_json(os.path.join(ROOT, "BENCHMARK.json"))[
            "run_seconds"]
    clock = bench.Clock()
    run = bench.generator(cell_).run(cell_, seed, seconds, traced, "cuda",
                                     clock)
    window_ns = int((clock.t0 + run.setup_s) * 1e9)
    run.device.update({"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0), "count": 1})
    correct, rows = bench.judge(run, cell_.limits)
    out = {"card": card(), "torch": torch.__version__, "workload": workload,
           "seed": seed, "trace": trace_arg, "seconds": seconds,
           "line": result_line(cell_, run, correct, rows, int(traced)),
           "steps": call_summary(calls, window_ns)}
    if traced:
        rec = timing.recorded()
        spans = rec["spans"]
        out["recorded"] = {"spans": len(spans), "dropped": rec["dropped"],
                           "counters": rec["counters"]}
        out["spans_a_top"] = span_counts(spans)
        out["step_cover"] = step_cover(spans)
        out["prefetch_cover"] = prefetch_cover(spans)
        out["medians_ms"] = span_medians(spans)
        if stash:
            start, window = stash[-1]
            out["idle_by_span"] = idle_by_span(spans, start, window)
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: out[k] for k in ("card", "workload", "seed",
                                          "trace", "line")}), flush=True)


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

def cost(out_path: str) -> None:
    from leod_tpu_torch import timing

    n = 200_000

    def ns(body):
        rounds = []
        for _ in range(5):
            t = time.perf_counter_ns()
            body()
            rounds.append((time.perf_counter_ns() - t) / n)
        return statistics.median(rounds)

    def loop():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with timing.span("x"):
                pass

    def counts():
        for _ in range(n):
            timing.count("x", 1)

    def laps():
        for _ in range(n):
            with timing.lap(None, "x"):
                pass
    out = {"card": card(), "loop_ns": ns(loop), "span_off_ns": ns(spans),
           "count_off_ns": ns(counts), "lap_off_ns": ns(laps)}
    with timing.recording():
        out["span_on_ns"] = ns(spans)
        out["count_on_ns"] = ns(counts)
    timing.reset()
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def profile(out_path: str) -> None:
    from dataclasses import replace

    import torch

    from leod_tpu_torch.config import derive, experiment_preset
    from leod_tpu_torch.data.synthetic import render_array_dataset
    from leod_tpu_torch.train.trainer import Trainer

    try:
        torch.profiler._ExperimentalConfig(profile_all_threads=True)
        all_threads = True
    except TypeError:
        all_threads = False
    cfg = experiment_preset("gen1", "tiny")
    bb = replace(cfg.model.backbone, in_res_hw=(64, 96),
                 partition_size=(2, 3))
    save = tempfile.mkdtemp(prefix="trace_window_")
    cfg = derive(replace(
        cfg, model=replace(cfg.model, backbone=bb),
        dataset=replace(cfg.dataset, resolution_hw=(64, 96),
                        sequence_length=4),
        training=replace(cfg.training, batch_size_train=4,
                         val_check_interval=0, viz_every_steps=0),
        save_dir=save, exp_name="profile"))
    seqs = render_array_dataset(cfg.dataset, num_train=3, num_val=0,
                                num_test=0, seed=0, num_reprs=40,
                                label_every=3, first_label_repr=4,
                                hw=(64, 96))["train"]
    trainer = Trainer(cfg, dtype=torch.bfloat16, device="cuda")
    trainer.fit(max_steps=9, sequences=seqs, profile_steps=2)
    trainer.close()
    with open(os.path.join(trainer.run_dir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(save, ignore_errors=True)
    leod = [e for e in events if str(e.get("name", "")).startswith("leod.")]
    threads = {}
    for e in leod:
        threads.setdefault(str(e.get("tid")), {}).setdefault(e["name"], 0)
        threads[str(e.get("tid"))][e["name"]] += 1
    out = {"card": card(), "torch": torch.__version__,
           "profile_all_threads_accepted": all_threads,
           "leod_events": len(leod), "by_thread": threads,
           "kernels": sum(e.get("cat") == "kernel" for e in events)}
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["cell"] and len(argv) in (5, 6) \
            and argv[3] in ("0", "1", "toggle"):
        cell(argv[1], int(argv[2]), argv[3], argv[4],
             float(argv[5]) if len(argv) == 6 else None)
    elif argv[:1] == ["cost"] and len(argv) == 2:
        cost(argv[1])
    elif argv[:1] == ["profile"] and len(argv) == 2:
        profile(argv[1])
    else:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
