"""The device's idle share of the traced steps, in %: 1 - (union of the
device events' intervals) / (the traced steps' wall time), both from
the same profiled stretch."""


def read(run):
    w = run.trace.get("window")
    if w is None or w.wall_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.wall_s)
