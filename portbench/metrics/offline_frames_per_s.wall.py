"""Event frames streamed through the detector per second: the reprs of
every slot's sequence that the window's batches ran (padding not
counted), over the window's seconds (from its start to the end of the
last batch's NMS and bridge), its profiled batches included. Host
clock; a per-layer metric, since the loop is host-bound and its rate
swings with the shared host (`PERF.md` §2)."""


def read(run):
    if "frames" not in run.values or run.window_s <= 0:
        return None
    return run.values["frames"] / run.window_s
