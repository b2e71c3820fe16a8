"""Event frames trained per second of wall time: batch x window length x the optimizer steps completed in the window, over the window's seconds (to the end of the last step, synchronized), its profiled steps included. Host clock; a per-layer metric, since the loop is host-bound and its rate swings with the shared host (`PERF.md` §2)."""


def read(run):
    return run.values["frames"] / run.window_s if "frames" in run.values and run.window_s > 0 else None
