"""The port's tracer: named host spans and counters kept in memory, and
the host timers of the entry points' optional `timings` dicts, which
are spans too.

    with timing.span("step.forward"):      # a span
        ...
    timing.count("h2d.pinned_bytes", n)    # a counter
    with timing.lap(timings, "step_ms", sync=device):
        ...                                # a span, and ms in timings

Tracing is off by default: `span` then returns one shared no-op and
`count` returns at once, each after one check of a module global; no
span is allocated, no profiler range entered, nothing synchronized. It
is on while any `recording()` is entered (the entry points enter one
while they run with `timings` given, and `Trainer.fit` for its profiled
steps), in every thread of the process.

On, each span records its name, its index and its parent's (the span
open in the same thread when it opened, or -1), its thread's name, its
start and end on `time.perf_counter_ns()`, a batch identifier (its
parent's where none is given), and whether a torch profiler was on when
it opened (`profiled`); under a profiler it is also a
`torch.profiler.record_function` range named "leod.<name>". A span
never synchronizes. `torch.profiler`'s `profiling_start_time_ns` is on
the same clock and its events' `time_range`s are us from it, so a span
can be placed on the device trace's timeline, one opened in a thread
the profiler did not trace included. The spans go to a bounded buffer
(CAPACITY, the oldest dropped and counted); `recorded()` returns them
with the counters, which accumulate until `reset()`.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 20
PROFILER_PREFIX = "leod."


class Span(NamedTuple):
    name: str
    index: int
    parent: int              # the enclosing span's index in its thread, or -1
    thread: str
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    batch: Optional[int]
    profiled: bool           # a torch profiler was on when it opened

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_depth = 0                   # recording() levels entered; on while > 0
_lock = threading.Lock()
_local = threading.local()   # the open spans of each thread
_ids = itertools.count()
_spans: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_dropped = 0


def tracing() -> bool:
    """Whether spans and counters are recorded now."""
    return _depth > 0


def _add(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(s)


class _Open:
    """A span while it is open."""
    __slots__ = ("name", "batch", "index", "parent", "start", "profiled",
                 "range", "stack")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        top = stack[-1] if stack else None
        if top is not None:
            self.parent = top.index
            if self.batch is None:
                self.batch = top.batch
        else:
            self.parent = -1
        self.index = next(_ids)
        self.profiled = _profiler._is_profiler_enabled
        self.range = None
        if self.profiled:
            self.range = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.stack.pop()
        _add(Span(self.name, self.index, self.parent,
                  threading.current_thread().name, self.start, end,
                  self.batch, self.profiled))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, batch: Optional[int] = None):
    """A context manager: the span `name` while tracing is on, else a
    shared no-op."""
    if not _depth:
        return _OFF
    return _Open(name, batch)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` while tracing is on."""
    if not _depth:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


class _Lap(_Open):
    """A span whose host ms go to `timings[key]`, after synchronizing
    `sync` where it is a card; it times with tracing off too."""
    __slots__ = ("timings", "sync", "on")

    def __init__(self, timings, key, sync, batch):
        super().__init__(key, batch)
        self.timings, self.sync = timings, sync

    def __enter__(self):
        self.on = bool(_depth)
        if self.on:
            return super().__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        if self.on:
            super().__exit__(*exc)
        self.timings.setdefault(self.name, []).append(
            (time.perf_counter_ns() - self.start) / 1e6)
        return False


def lap(timings: Optional[Dict[str, List[float]]], key: str,
        sync: Optional[torch.device] = None, batch: Optional[int] = None):
    """A context manager: where `timings` is given, appends the host ms
    of its body to `timings[key]`, after synchronizing `sync` when it is
    a card; while tracing is on, the span `key` over the same interval,
    parent of the spans opened inside it."""
    if timings is None:
        return span(key, batch)
    return _Lap(timings, key, sync, batch)


def begin() -> None:
    """Tracing on until the matching `end()`."""
    global _depth
    with _lock:
        _depth += 1


def end() -> None:
    global _depth
    with _lock:
        _depth = max(_depth - 1, 0)


@contextlib.contextmanager
def recording(on: bool = True) -> Iterator[None]:
    """Tracing on within it, where `on`."""
    if not on:
        yield
        return
    begin()
    try:
        yield
    finally:
        end()


def traced(fn: Callable) -> Callable:
    """`fn` with tracing on while it runs where it is given the keyword
    argument `timings` (an entry point's host timers)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with recording(kwargs.get("timings") is not None):
            return fn(*args, **kwargs)
    return run


def recorded() -> Dict:
    """{"spans": [Span] in the order they closed, "counters": {name: n},
    "dropped": spans dropped from the full buffer} since `reset()`."""
    with _lock:
        return {"spans": list(_spans), "counters": dict(_counters),
                "dropped": _dropped}


def reset() -> None:
    """Drops what was recorded."""
    global _spans, _dropped
    with _lock:
        _spans = collections.deque(maxlen=CAPACITY)
        _counters.clear()
        _dropped = 0
