"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole tiny cell on the CPU (everything but the
harness's look for a card, `tiny.py`) held to the real cell's limits,
with one fault planted in the program: a step that returns its state
unchanged, half of the batch left out with the mean taken over the
rest (in the forward, or in the loss alone), or an answer altered where
it is produced. A sound run comes out
correct, and the lower-precision control breaks a limit at this size
too. (One card: no exchange between chips to leave out.)
"""
from __future__ import annotations

import os
import sys

import pytest
import torch

from portbench import bench

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout")))


def _correct(root, workload, seed=5):
    torch.manual_seed(0)
    cell = bench.find_cell(root, workload)
    # the eval's handed-on state is compared from a pass's second batch
    # on: a window that holds several batches on a loaded CPU
    seconds = 3.0 if workload == "tiny_eval" else 0.5
    run = bench.generator(cell).run(cell, seed, seconds, False, "cpu",
                                    bench.Clock())
    ok, rows = bench.judge(run, cell.limits)
    return ok, rows


@pytest.mark.parametrize("workload", ["tiny_train", "tiny_eval"])
def test_sound_run_is_correct(root, workload):
    ok, rows = _correct(root, workload)
    assert ok, rows


def test_train_state_left_unchanged(root, monkeypatch):
    from leod_tpu_torch.train import optim

    def no_update(self):
        self.count += 1
    monkeypatch.setattr(optim.ClipAdamW, "step", no_update)
    ok, rows = _correct(root, "tiny_train")
    assert not ok, rows


def test_train_half_batch(root, monkeypatch):
    """The step computes on the first half of its rows twice over: the
    second half left out, the mean taken over the rest."""
    from leod_tpu_torch.train import trainer as tr_mod
    make = tr_mod.make_train_step

    def half(v):
        v = v.clone()
        dim = 1 if v.dim() == 5 else 0
        b = v.shape[dim]
        v.narrow(dim, b - b // 2, b // 2).copy_(v.narrow(dim, 0, b // 2))
        return v

    def patched(*a, **k):
        step = make(*a, **k)
        return lambda state, batch: step(state, {n: half(t) for n, t in
                                                 batch.items()})
    monkeypatch.setattr(tr_mod, "make_train_step", patched)
    ok, rows = _correct(root, "tiny_train")
    assert not ok, rows


def test_train_half_loss(root, monkeypatch):
    """The step runs every row forward but takes its loss over the first
    half of the rows: the second half's frame mask and labels dropped
    after the forward (the mask enters only the loss)."""
    from leod_tpu_torch.train import trainer as tr_mod
    make = tr_mod.make_train_step

    def drop(batch):
        out = dict(batch)
        for n in ("frame_mask", "labels"):
            v = batch[n].clone()
            v[v.shape[0] - v.shape[0] // 2:] = 0
            out[n] = v
        return out

    def patched(*a, **k):
        step = make(*a, **k)
        return lambda state, batch: step(state, drop(batch))
    monkeypatch.setattr(tr_mod, "make_train_step", patched)
    ok, rows = _correct(root, "tiny_train")
    assert not ok, rows


def _wrap_eval_step(monkeypatch, fault):
    from leod_tpu_torch.train import trainer as tr_mod
    make = tr_mod.make_eval_step

    def patched(*a, **k):
        step = make(*a, **k)
        return lambda states, batch: fault(step, states, batch)
    monkeypatch.setattr(tr_mod, "make_eval_step", patched)


def test_eval_state_left_unchanged(root, monkeypatch):
    def fault(step, states, batch):
        return states, step(states, batch)[1]
    _wrap_eval_step(monkeypatch, fault)
    ok, rows = _correct(root, "tiny_eval")
    assert not ok, rows


def test_eval_half_batch(root, monkeypatch):
    def fault(step, states, batch):
        b = dict(batch)
        ev = b["ev"].copy()
        ev[:, ev.shape[1] // 2:] = 0
        b["ev"] = ev
        return step(states, b)
    _wrap_eval_step(monkeypatch, fault)
    ok, rows = _correct(root, "tiny_eval")
    assert not ok, rows


def test_eval_answer_altered(root, monkeypatch):
    from leod_tpu_torch.train import trainer as tr_mod
    post = tr_mod.postprocess

    def altered(*a, **k):
        dets, valid = post(*a, **k)
        dets = dets.clone()
        dets[..., 0, 4] += 0.01           # the first kept box's objectness
        return dets, valid
    monkeypatch.setattr(tr_mod, "postprocess", altered)
    ok, rows = _correct(root, "tiny_eval")
    assert not ok, rows


@pytest.mark.parametrize("workload", ["tiny_train", "tiny_eval"])
def test_control_breaks_a_limit(root, workload):
    """The reference in fp8 in the program's place fails at least one of
    the cell's limits (`calibrate`'s "control_fp8" readings)."""
    cell = bench.find_cell(root, workload)
    r = bench.generator(cell).calibrate(cell, 6, "cpu", 0.5)
    assert all(v <= cell.limits[k] for k, v in r["sound"].items()), r
    assert any(v > cell.limits[k] for k, v in r["control_fp8"].items()), r


@pytest.mark.gpu
def test_tiny_cells_on_the_card(root):
    """The tiny cells through the card's path: CUDA kernels, the
    profiled window and every per-layer reader."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for w in ("tiny_train", "tiny_eval"):
        cell = bench.find_cell(root, w)
        run = bench.generator(cell).run(cell, 7, 2.0, True, "cuda", bench.Clock())
        assert bench.judge(run, cell.limits)[0], run.checks
        assert run.trace["window"] is not None
        for m in cell.per_layer:
            bench.read_metric(cell, m["name"], run)
