"""Mean host ms a batch of `run_streaming_eval`'s "step_ms" timing in
the traced window."""


def read(run):
    return run.values.get("step_ms")
