"""The share of the train loop's gets from the prefetch queue that found
it empty, in %: 100 x the program's counter "prefetch.empty_gets" over
"prefetch.gets" (`data/loader.py` `Prefetcher`) in the traced window.
None where the program counts no get."""


def read(run):
    from leod_tpu_torch import timing
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    c = recorded()["counters"]
    gets = c.get("prefetch.gets", 0)
    return 100.0 * c.get("prefetch.empty_gets", 0) / gets if gets else None
