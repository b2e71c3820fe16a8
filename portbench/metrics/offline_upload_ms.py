"""Median host ms an eval step spent handing its inputs to the card: the
program's "step.upload" spans (`make_eval_step`: the frames, frame
indices and reset flags from pageable host memory), over the batches
whose spans all opened with the profiler off. None where the program
records no such span, or none opened with the profiler off."""

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
        if s.name == "step.upload":
            groups.setdefault((s.batch, s.parent), []).append(s)
    ms = [sum(s.end_ns - s.start_ns for s in g) / 1e6
          for g in groups.values() if not any(s.profiled for s in g)]
    return statistics.median(ms) if ms else None
