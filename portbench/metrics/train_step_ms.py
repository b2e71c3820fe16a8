"""Mean host ms of a train step in the traced window (`Trainer.fit(timings=)` "step_ms": the step, ending in a device synchronize)."""


def read(run):
    return run.values.get("step_ms")
