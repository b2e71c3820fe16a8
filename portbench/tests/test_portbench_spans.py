"""The per-layer metrics that read the program's own spans and counters
(`leod_tpu_torch/timing.py`): each reads None without a recording,
without the tracer's functions (a program that has no spans), and where
every batch was profiled; it reads the expected number from a synthetic
recording, with two eval passes' batches kept apart."""
from __future__ import annotations

import os

import pytest

from leod_tpu_torch import timing
from portbench import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MIB = 2 ** 20

# metric -> (cell, reading of the synthetic recording)
EXPECTED = {
    "train_load_ms": ("gen4_train_b12", 20.0),
    "train_augment_ms": ("gen4_train_b12", 6.0),
    "train_harvest_ms": ("gen4_train_b12", 20.0),
    "train_upload_ms": ("gen4_train_b12", 20.0),
    "train_starved_share": ("gen4_train_b12", 90.0),
    "train_forward_host_ms": ("gen4_train_b12", 20.0),
    "train_loss_host_ms": ("gen4_train_b12", 20.0),
    "train_backward_host_ms": ("gen4_train_b12", 20.0),
    "train_optimizer_host_ms": ("gen4_train_b12", 20.0),
    "offline_fold_ms": ("gen1_eval_b16", 20.0),
    "offline_upload_ms": ("gen1_eval_b16", 20.0),
    "offline_pageable_mib": ("gen1_eval_b16", 525.0),
}


def _synthetic():
    """Three batches (1-3) of every span the metrics read, each 10 x n
    ms (the augmentor's two calls n and 2n ms), and a fourth batch
    opened under the profiler, 1000 ms, which the medians leave out."""
    spans, ids = [], iter(range(10 ** 6))

    def add(name, batch, ms, parent=-1, profiled=False):
        i = next(ids)
        spans.append(timing.Span(name, i, parent, "t", 0, int(ms * 1e6),
                                 batch, profiled))
        return i

    for n in (1, 2, 3, 4):
        prof = n == 4
        ms = 1000.0 if prof else 10.0 * n
        load = add("load", n, ms, profiled=prof)
        add("load.augment", n, 1000.0 if prof else n, load, prof)
        add("load.augment", n, 1000.0 if prof else 2 * n, load, prof)
        add("harvest", n, ms, profiled=prof)
        add("upload", n, ms, profiled=prof)
        lap = add("step_ms", n, 2 * ms, profiled=prof)
        for ph in ("forward", "loss", "backward", "optimizer"):
            add("step." + ph, n, ms, lap, prof)
        hl = add("harvest_ms", n - 1, 2 * ms, profiled=prof)
        add("harvest.fold", n - 1, ms, hl, prof)
        el = add("step_ms", n - 1, 2 * ms, profiled=prof)
        add("step.upload", n - 1, ms, el, prof)
    counters = {"prefetch.gets": 10, "prefetch.empty_gets": 9,
                "h2d.pageable_bytes": 4 * 525 * MIB}
    return {"spans": spans, "counters": counters, "dropped": 0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_reads_the_recording(name, monkeypatch):
    cell_name, want = EXPECTED[name]
    cell = bench.find_cell(REPO, cell_name)
    assert name in {m["name"] for m in cell.per_layer}
    run = bench.Run()
    timing.reset()
    assert bench.read_metric(cell, name, run) is None
    monkeypatch.setattr(timing, "recorded", _synthetic)
    assert bench.read_metric(cell, name, run) == pytest.approx(want)
    # a program without the tracer's functions: nothing, and no raise
    monkeypatch.delattr(timing, "recorded")
    assert bench.read_metric(cell, name, run) is None


SPAN_METRICS = sorted(n for n in EXPECTED if n.endswith("_ms"))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_none_where_every_batch_was_profiled(
        name, monkeypatch):
    """The profiled batches run slower on the host: a reading is never
    taken from them, even where no other batch was recorded."""
    cell = bench.find_cell(REPO, EXPECTED[name][0])
    rec = _synthetic()
    rec["spans"] = [s for s in rec["spans"] if s.profiled]
    monkeypatch.setattr(timing, "recorded", lambda: rec)
    assert bench.read_metric(cell, name, bench.Run()) is None


def test_span_metric_keeps_two_passes_batches_apart(monkeypatch):
    """Eval passes number their batches alike, each batch under a lap
    of its own: the batches are told apart by their laps, and a batch's
    spans under one lap are summed."""
    def sp(name, index, parent, batch, ms):
        return timing.Span(name, index, parent, "t", 0, int(ms * 1e6),
                           batch, False)
    spans = [sp("harvest_ms", 0, -1, 0, 10), sp("harvest.fold", 1, 0, 0, 4),
             sp("harvest.fold", 2, 0, 0, 2),
             sp("harvest_ms", 3, -1, 1, 10), sp("harvest.fold", 4, 3, 1, 8),
             sp("harvest_ms", 5, -1, 0, 10), sp("harvest.fold", 6, 5, 0, 7),
             sp("harvest_ms", 7, -1, 1, 10), sp("harvest.fold", 8, 7, 1, 9)]
    rec = {"spans": spans, "counters": {}, "dropped": 0}
    monkeypatch.setattr(timing, "recorded", lambda: rec)
    cell = bench.find_cell(REPO, "gen1_eval_b16")
    # batches of 6, 8, 7 and 9 ms
    assert bench.read_metric(cell, "offline_fold_ms", bench.Run()) == 7.5
