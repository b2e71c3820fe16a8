"""Median host ms a train batch took in the prefetch thread's loader:
the program's "load" spans (`Trainer.fit`: the loader's next batch,
window reads, augmentation and collate), one a batch under the number of
the step that consumes it, over the batches whose spans all opened with
the profiler off. None where the program records no such span, or none
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
        if s.name == "load":
            groups.setdefault((s.batch, s.parent), []).append(s)
    ms = [sum(s.end_ns - s.start_ns for s in g) / 1e6
          for g in groups.values() if not any(s.profiled for s in g)]
    return statistics.median(ms) if ms else None
