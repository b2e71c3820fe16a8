"""Card ms of kernel work a frame trained: the union of the kernels'
intervals (copies and fills left out) over the profiled steps, over the
frames those steps trained (batch x window length x steps). Profiled in
every run, trace or not; None where no stretch was profiled."""


def read(run):
    w = run.trace.get("window")
    n = run.values.get("profiled_frames")
    if w is None or not n:
        return None
    busy = w.kernel_busy_s()
    return 1e3 * busy / n if busy > 0 else None
