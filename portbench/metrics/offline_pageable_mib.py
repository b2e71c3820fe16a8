"""MiB an eval batch copied to the card from pageable host memory: the
program's counter "h2d.pageable_bytes" over its "step.upload" spans, one
an eval step, in the traced window. None where the program records
neither."""


def read(run):
    from leod_tpu_torch import timing
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    steps = sum(s.name == "step.upload" for s in rec["spans"])
    n = rec["counters"].get("h2d.pageable_bytes", 0)
    return n / 2 ** 20 / steps if steps and n else None
