"""Median host ms a train step spent issuing its forward phase: the
program's "step.forward" spans (`make_train_step`: resetting the rows
that start a sequence, the backbone over the window under its remat
policy, the gather of the labeled frames and the FPN and head), over the
steps whose span opened with the profiler off. Host time: the card runs
the work behind it. None where the program records no such span, or none
opened with the profiler off."""

import statistics


def read(run):
    from leod_tpu_torch import timing
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    # a batch's spans: one batch id's under one parent span (two eval
    # passes number their batches alike, under laps of their own)
    groups = {}
    for s in recorded()["spans"]:
        if s.name == "step.forward":
            groups.setdefault((s.batch, s.parent), []).append(s)
    ms = [sum(s.end_ns - s.start_ns for s in g) / 1e6
          for g in groups.values() if not any(s.profiled for s in g)]
    return statistics.median(ms) if ms else None
