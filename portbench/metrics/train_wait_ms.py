"""Mean host ms a step waited for the prefetch thread's batch in the traced window (`Trainer.fit(timings=)` "wait_ms")."""


def read(run):
    return run.values.get("wait_ms")
