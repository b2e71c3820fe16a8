"""Reading a torch.profiler window: the device's busy time, the idle
gaps by the harness span open on the host, the device operations that
took longest, and the port's kernels with their launch counts.

`busy_us` and `Stretch`'s count check are frozen copies of
`chip_smoke.py` `_busy_us` (lines 1429-1437) and `profile_calls`
(lines 1440-1477): `torch.profiler` drops events (a window once held no
launch at all), so a stretch whose port-kernel events fall short of the
launches the ops counted in it is profiled again.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench."
PROFILE_TRIES = 3
# the port's hand-written kernels, by the names in their signatures
PORT_KERNELS = ("block_attention_kernel", "block_mlp_kernel",
                "lstm_update_kernel", "nms_build_kernel", "nms_sweep_kernel",
                "block_residual_kernel")
# launches a counted op call makes: the NMS op is two kernels
KERNELS_A_CALL = {"block_attention": 1, "block_mlp": 1, "lstm_update": 1,
                  "nms_mask": 2}
# device events that are copies or fills, not kernels
COPY_PREFIXES = ("Memcpy", "Memset")


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        s = max(s, end)
        if e > s:
            busy += e - s
        end = max(end, e)
    return busy


def op_launches() -> int:
    """Kernel launches the port's counted ops have made so far."""
    from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
    ops = {"block_attention": maxvit_cuda.block_attention,
           "block_mlp": maxvit_cuda.block_mlp,
           "lstm_update": maxvit_cuda.lstm_update,
           "nms_mask": nms_cuda.nms_mask}
    return sum(ops[k].launches * n for k, n in KERNELS_A_CALL.items())


def kernel_of(name: str) -> Optional[str]:
    for k in PORT_KERNELS:
        if re.search(rf"\b{k}\b", name):
            return k
    return None


class Window:
    """One profiled stretch: device events, harness spans, wall s."""

    def __init__(self, prof, wall_s: float, tries: int):
        from torch.autograd import DeviceType
        self.wall_s = wall_s
        self.tries = tries
        self.device = []
        self.spans = []
        for e in prof.events():
            tr = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # a user annotation is laid over its kernels and gaps
                if not getattr(e, "is_user_annotation", False):
                    self.device.append((e.name, tr[0], tr[1]))
            elif e.name.startswith(SPAN_PREFIX):
                self.spans.append((e.name[len(SPAN_PREFIX):], tr[0], tr[1]))

    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device]) / 1e6

    def kernel_busy_s(self) -> float:
        """Seconds in which a kernel ran: the union of the device events'
        intervals, copies and fills left out."""
        return busy_us([(s, e) for n, s, e in self.device
                        if not n.startswith(COPY_PREFIXES)]) / 1e6

    def kernel_us(self) -> Dict[str, List[Tuple[str, float]]]:
        """{port kernel: [(full name, device us), ...]}."""
        out: Dict[str, List[Tuple[str, float]]] = {}
        for n, s, e in self.device:
            k = kernel_of(n)
            if k is not None:
                out.setdefault(k, []).append((n, e - s))
        return out

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v / 1e6] for k, v in top]

    outside = "outside the harness spans"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time between the first and the last event, summed
        by the innermost harness span open at each gap's midpoint (or
        `outside`, which a generator names for its loop)."""
        iv = sorted((s, e) for _, s, e in self.device)
        gaps, end = [], None
        for s, e in iv:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        tot: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = [(s1 - s0, nm) for nm, s0, s1 in self.spans
                     if s0 <= mid <= s1]
            name = min(open_)[1] if open_ else self.outside
            tot[name] = tot.get(name, 0.0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]


def span(name: str):
    """A host span the trace attributes idle gaps to."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Stretch:
    """torch.profiler over the stretch between `open()` and `close()`,
    each after a synchronize. `close()` returns the stretch's `Window`,
    or None where the profiler lost events: none on the device, or,
    with `count_kernels`, fewer port-kernel events than the ops counted
    launches in it. The caller profiles a later stretch then, up to
    PROFILE_TRIES times."""

    def __init__(self, count_kernels: bool):
        self.count_kernels = count_kernels
        self.prof = None
        self.tries = 0

    def open(self) -> None:
        import time

        import torch
        from torch.profiler import ProfilerActivity
        torch.cuda.synchronize()
        self.before = op_launches() if self.count_kernels else 0
        self.prof = torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def close(self) -> Optional[Window]:
        import time

        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.tries += 1
        w = Window(self.prof, wall, self.tries)
        self.prof = None
        if not w.device:
            return None
        if self.count_kernels:
            seen = sum(len(v) for v in w.kernel_us().values())
            if seen != op_launches() - self.before:
                return None
        return w
