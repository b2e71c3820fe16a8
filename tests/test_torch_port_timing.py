"""The port's tracer (`leod_tpu_torch/timing.py`) on the CPU: off, it
records nothing and enters no profiler range; on, spans carry their
parents, threads and batch ids (a prefetch thread's too), counters add,
the full buffer counts what it drops, `lap` times with tracing off and
is the parent of the spans inside it, a span under a profiler is
marked and lies on the profiler's clock, and `block_mlp` counts its
launch's plan only while tracing records and only on the card."""
import threading
import time

import pytest
import torch

from leod_tpu_torch import timing
from leod_tpu_torch.data.loader import Prefetcher
from leod_tpu_torch.models.layers import PartitionAttention
from leod_tpu_torch.ops import _build, maxvit_cuda


@pytest.fixture(autouse=True)
def _clean():
    timing.reset()
    yield
    timing.reset()


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timing.tracing()
    assert timing.span("a") is timing.span("b", batch=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with timing.span("a"):
            timing.count("c", 3)
    timings = {}
    with timing.lap(timings, "step_ms"):
        pass
    assert len(timings["step_ms"]) == 1 and timings["step_ms"][0] >= 0
    assert timing.recorded() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_carry_parents_threads_and_batches():
    def produce():
        for i in range(3):
            with timing.span("load", batch=10 + i):
                with timing.span("load.augment"):
                    pass
            yield i

    with timing.recording():
        assert timing.tracing()
        with timing.span("outer", batch=7) as outer:
            with timing.span("inner") as inner:
                timing.count("bytes", 5)
            timing.count("bytes", 2)
        with Prefetcher(produce()) as p:
            assert list(p) == [0, 1, 2]
    assert not timing.tracing()
    rec = timing.recorded()
    by = {}
    for s in rec["spans"]:
        by.setdefault(s.name, []).append(s)
    (o,), (i,) = by["outer"], by["inner"]
    assert (o.index, i.index) == (outer.index, inner.index)
    assert o.parent == -1 and i.parent == o.index
    assert i.batch == o.batch == 7
    assert o.thread == i.thread == threading.current_thread().name
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert not o.profiled
    assert [s.batch for s in by["load"]] == [10, 11, 12]
    assert {s.thread for s in by["load"]} == {"prefetch"}
    for s, aug in zip(by["load"], by["load.augment"]):
        assert aug.parent == s.index and aug.batch == s.batch
    assert rec["counters"]["bytes"] == 7
    assert rec["counters"]["prefetch.gets"] == 4      # 3 and the end
    assert rec["dropped"] == 0


def test_full_buffer_keeps_the_newest_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(timing, "CAPACITY", 4)
    timing.reset()
    with timing.recording():
        for k in range(6):
            with timing.span(f"s{k}"):
                pass
    rec = timing.recorded()
    assert [s.name for s in rec["spans"]] == ["s2", "s3", "s4", "s5"]
    assert rec["dropped"] == 2
    timing.reset()
    assert timing.recorded()["dropped"] == 0


def test_lap_is_a_span_and_the_parent_of_spans_inside():
    timings = {}
    with timing.recording():
        with timing.lap(timings, "step_ms", batch=4):
            with timing.span("step.forward"):
                time.sleep(0.002)
        with timing.lap(None, "wait_ms", batch=5):
            pass
    lap, fwd, wait = sorted(timing.recorded()["spans"],
                            key=lambda s: s.index)
    assert (lap.name, fwd.name, wait.name) == ("step_ms", "step.forward",
                                               "wait_ms")
    assert fwd.parent == lap.index and fwd.batch == 4 and wait.batch == 5
    assert list(timings) == ["step_ms"]
    assert timings["step_ms"][0] == pytest.approx(lap.ms, abs=0.5)
    assert timings["step_ms"][0] >= fwd.ms >= 2.0


def test_a_span_under_the_profiler_is_marked_and_on_its_clock():
    """`profiled` inside a torch profiler, and the span's start within
    2 ms of its "leod." event's `profiling_start_time_ns` +
    `time_range.start` (us)."""
    with timing.recording():
        with timing.span("before"):
            pass
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            for k in range(3):
                with timing.span(f"in{k}"):
                    time.sleep(0.003)
    spans = {s.name: s for s in timing.recorded()["spans"]}
    assert not spans["before"].profiled
    t0 = prof.profiler.profiling_start_time_ns
    events = {e.name: e for e in prof.events()
              if e.name.startswith(timing.PROFILER_PREFIX)}
    assert set(events) == {"leod.in0", "leod.in1", "leod.in2"}
    for k in range(3):
        s, e = spans[f"in{k}"], events[f"leod.in{k}"]
        assert s.profiled
        assert abs(s.start_ns - (t0 + e.time_range.start * 1e3)) < 2e6



def _mlp_block():
    return PartitionAttention(32, (2, 2), "window", dim_head=16).eval()


def test_block_mlp_counts_its_plan_while_recording(monkeypatch):
    """On the card (here the op and the library's `last_plan` stubbed,
    and the tensor taken for a card's), each `block_mlp` launch adds its
    plan's 64-row tiles, tiles a cluster split and CTAs to the counters,
    in all and for its width, only while tracing records."""
    plans = iter([[2, 80, 80, 160], [1, 1280, 0, 132]])
    ops = {"block_mlp": lambda x, o, *rest: x + o,
           "last_plan": lambda op: next(plans)}
    monkeypatch.setattr(_build, "op", ops.__getitem__)
    monkeypatch.setattr(maxvit_cuda, "_counts", lambda x: True)
    blk = _mlp_block()
    x = torch.randn(5, 32)
    maxvit_cuda.block_mlp(x, x, blk)
    assert timing.recorded()["counters"] == {}
    with timing.recording():
        maxvit_cuda.block_mlp(x, x, blk)
        maxvit_cuda.block_mlp(x, x, blk)
    want = {"tiles": 1360, "split_tiles": 80, "ctas": 292}
    assert timing.recorded()["counters"] == {
        **{f"block_mlp.{k}": v for k, v in want.items()},
        **{f"block_mlp.{k}.c32": v for k, v in want.items()}}


def test_block_mlp_on_the_cpu_counts_nothing():
    """On a CPU tensor the op runs its plain version: no launch, and no
    counter even while tracing records."""
    blk = _mlp_block()
    g = torch.Generator().manual_seed(0)
    x, o = torch.randn(2, 4, 6, 32, generator=g), torch.randn(2, 4, 6, 32,
                                                              generator=g)
    before = maxvit_cuda.block_mlp.launches
    with torch.no_grad(), timing.recording():
        got = maxvit_cuda.block_mlp(x, o, blk)
    assert torch.equal(got, maxvit_cuda.block_mlp_plain(x, o, blk))
    assert maxvit_cuda.block_mlp.launches == before
    assert timing.recorded()["counters"] == {}
