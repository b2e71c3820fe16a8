"""The port's training loop against the JAX package's on the CPU: the
train loaders' batches from one seed (stream, random access and mixed,
with the augmentations on, byte for byte), the augmentor, the in-memory
train split, `Trainer.fit` as a whole (the logged losses, the gradflow
metrics, the panels' steps and the final weights of three steps, 1e-4),
and the loop's own duties: the metrics JSONL, validation, checkpoints,
resume, `request_stop` and SIGTERM, the fallback past a corrupt
checkpoint, the profiler trace and the WandB sink."""
import json
import os
import signal
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.data import augment as jaug
from leod_tpu.data import loader as jl
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.train.trainer import Trainer as JTrainer

from leod_tpu_torch import timing
from leod_tpu_torch.config import experiment_preset, stem_fold_hw
from leod_tpu_torch.convert import _leaves, _target, load_jax_variables
from leod_tpu_torch.data import augment as taug
from leod_tpu_torch.data import loader as tl
from leod_tpu_torch.data.synthetic import render_array_dataset
from leod_tpu_torch.train.trainer import MetricLogger, Trainer

from test_torch_port_serve import _tiny

HW = (64, 96)
L = 4
SEED = 3
SPLIT = dict(num_train=3, num_val=2, num_test=0, seed=SEED, num_reprs=30,
             label_every=3, first_label_repr=4, hw=HW)
AUG_ALL = dict(prob_hflip=0.5, prob_tflip=0.5, rotate_prob=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores, and torch's
    thread pool in each would oversubscribe them: these many small ops
    then run tens of times slower. They run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A Gen1-format dataset written by the JAX package's generator."""
    return j_generate_dataset(str(tmp_path_factory.mktemp("gen1")), **SPLIT)


def _cfg(preset, root, save_dir, augment=None, **training):
    cfg = _tiny(preset)
    dst = replace(cfg.dataset, path=root, resolution_hw=HW, sequence_length=L)
    if augment:
        zoom = replace(dst.augment_random.zoom, prob=0.9, zoom_out_weight=4.0,
                       zoom_in_max=1.4, zoom_out_max=1.3)
        dst = replace(dst, augment_random=replace(
            dst.augment_random, zoom=zoom, **augment),
            augment_stream=replace(dst.augment_stream, zoom=zoom, **augment))
    tr = replace(cfg.training, **{**dict(
        batch_size_train=3, batch_size_eval=2, val_check_interval=0,
        max_det_frames=3), **training})
    return replace(cfg, dataset=dst, training=tr, save_dir=str(save_dir),
                   exp_name="run")


def _same_batch(got, want, paths=True):
    for k in ("ev", "is_first", "is_last", "is_padded", "ev_idx",
              "is_reversed"):
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    if paths:
        assert got["paths"] == want["paths"]
    for key in ("labels", "skipped"):
        for trow, jrow in zip(got[key], want[key]):
            for tb, jb in zip(trow, jrow):
                assert (tb is None) == (jb is None), key
                if tb is not None:
                    assert np.array_equal(tb.arr, jb.arr), key


def _loader(mod, cfg, seqs, kind, seed, offset):
    dst = cfg.dataset
    if kind == "stream":
        return mod.StreamTrainLoader(seqs, dst, 3, seed, slot_offset=offset)
    if kind == "random":
        return mod.RandomTrainLoader(seqs, dst, 3, seed, slot_offset=offset)
    return mod.MixedTrainLoader(
        mod.StreamTrainLoader(seqs, dst, 1, seed, slot_offset=offset),
        mod.RandomTrainLoader(seqs, dst, 2, seed, slot_offset=offset))


@pytest.mark.parametrize("augment", [None, AUG_ALL])
@pytest.mark.parametrize("kind,seed,offset", [("stream", 0, 0),
                                              ("stream", 5, 2),
                                              ("random", 1, 0),
                                              ("random", 2, 3),
                                              ("mixed", 0, 0)])
def test_train_loaders_match_jax(root, tmp_path, kind, seed, offset,
                                 augment):
    """The first batches of each loader from one seed are the JAX
    loader's, byte for byte, and so are their harvests."""
    tcfg = _cfg(experiment_preset, root, tmp_path, augment)
    jcfg = _cfg(j_experiment_preset, root, tmp_path, augment)
    tit = iter(_loader(tl, tcfg, tl.open_split_sequences(tcfg.dataset,
                                                         "train"),
                       kind, seed, offset))
    jit_ = iter(_loader(jl, jcfg, jl.open_split_sequences(jcfg.dataset,
                                                          "train"),
                        kind, seed, offset))
    fold = stem_fold_hw(tcfg.model)
    for _ in range(4):
        got, want = next(tit), next(jit_)
        _same_batch(got, want)
        th = tl.harvest_frames(got, 3, 8, tcfg.model.backbone.in_res_hw,
                               fold_hw=fold)
        jh = jl.harvest_frames(want, 3, 8, jcfg.model.backbone.in_res_hw,
                               fold_hw=fold)
        for k in ("ev", "is_first", "frame_t", "frame_mask", "labels"):
            assert np.array_equal(th[k], jh[k]), k


def test_in_memory_train_split_gives_jax_batches(root, tmp_path):
    """`render_array_dataset` from the generator's seed makes the split
    the JAX package wrote: the mixed loader over it (no h5 file) gives
    the JAX loader's batches over the files."""
    tcfg = _cfg(experiment_preset, root, tmp_path, AUG_ALL)
    jcfg = _cfg(j_experiment_preset, root, tmp_path, AUG_ALL)
    kw = {k: v for k, v in SPLIT.items()
          if k not in ("num_train", "num_val", "num_test", "seed")}
    splits = render_array_dataset(tcfg.dataset, 3, 2, 0, seed=SEED, **kw)
    assert [len(splits[s]) for s in ("train", "val", "test")] == [3, 2, 0]
    assert splits["train"][1].seq_dir == os.path.join("train", "seq_001")
    tit = iter(_loader(tl, tcfg, splits["train"], "mixed", 4, 0))
    jit_ = iter(_loader(jl, jcfg, jl.open_split_sequences(jcfg.dataset,
                                                          "train"),
                        "mixed", 4, 0))
    for _ in range(3):
        _same_batch(next(tit), next(jit_), paths=False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentor_matches_jax(root, tmp_path, seed):
    cfg = _cfg(experiment_preset, root, tmp_path, AUG_ALL).dataset
    seq = tl.open_split_sequences(cfg, "train")[seed % 3]
    win = tl.WindowedSequence(seq, L)
    sample = win[len(win) // 2]
    aug_t = taug.SpatialAugmentor(cfg.loading_hw, cfg.augment_random,
                                  np.random.default_rng(seed))
    aug_j = jaug.SpatialAugmentor(cfg.loading_hw, cfg.augment_random,
                                  np.random.default_rng(seed))
    for _ in range(6):
        aug_t.randomize()
        aug_j.randomize()
        assert asdict(aug_t.params) == asdict(aug_j.params)
        got, want = aug_t.apply(sample), aug_j.apply(sample)
        assert got["ev_repr"].tobytes() == want["ev_repr"].tobytes()
        for tb, jb in zip(got["labels"], want["labels"]):
            assert (tb is None) == (jb is None)
            if tb is not None:
                assert np.array_equal(tb.arr, jb.arr)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _records(trainer):
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_matches_jax_trainer(root, tmp_path):
    """Three steps of `Trainer.fit` from one set of weights, with gradflow
    on and a panel every 2 steps: the losses logged at every step, the
    `gradflow/*` metrics (the same keys; values within 1e-4, and 1e-3
    relative: SimOTA's regression head sums many rounded terms), the
    panels' step numbers (<run_dir>/viz/step*.png) and the final weights and BN
    statistics are the JAX `Trainer.fit`'s (1e-4; the preset's first
    learning rates, as in `test_torch_port_train_step.py`)."""
    flags = dict(gradflow=True, viz_every_steps=2)
    jcfg = _cfg(j_experiment_preset, root, tmp_path / "j", **flags)
    tcfg = _cfg(experiment_preset, root, tmp_path / "t", **flags)
    jtr = JTrainer(jcfg, dtype=jnp.float32)
    jstate = jtr.init_state(3)
    v = jax.tree.map(np.asarray, jstate.variables)
    jstate = jtr.fit(max_steps=3, state=jstate, log_every=1)
    jtr.close()
    ttr = Trainer(tcfg, dtype=torch.float32, device="cpu")
    tstate = ttr.init_state(3)
    load_jax_variables(ttr.det, v)
    tstate = ttr.fit(max_steps=3, state=tstate, log_every=1)
    ttr.close()
    assert tstate.step == 3
    got, want = _records(ttr), _records(jtr)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg",
                  "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
        flow = sorted(k for k in w if k.startswith("gradflow/"))
        assert len(flow) == len(jax.tree.leaves(v["params"]))
        assert sorted(k for k in g if k.startswith("gradflow/")) == flow
        for k in flow:
            assert abs(g[k] - w[k]) <= 1e-4, k
            assert g[k] == pytest.approx(w[k], rel=1e-3, abs=1e-7), k
    panels = [sorted(os.listdir(os.path.join(t.run_dir, "viz")))
              for t in (ttr, jtr)]
    assert panels[0] == panels[1] == ["step00000002.png"]
    var = jax.tree.map(np.asarray, jstate.variables)
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(var[coll]):
            module = ttr.det.get_submodule(".".join(path[:-1]))
            name, want_t = _target(module, path[-1], arr)
            got_t = getattr(module, name).detach().numpy()
            np.testing.assert_allclose(
                got_t, want_t, rtol=1e-4,
                atol=1e-4 * max(1.0, float(np.abs(want_t).max())),
                err_msg="/".join(path))


def test_fit_logs_validates_checkpoints_and_resumes(root, tmp_path):
    cfg = _cfg(experiment_preset, root, tmp_path, val_check_interval=1)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    timings = {}
    timing.reset()
    state = trainer.fit(max_steps=2, log_every=1, timings=timings)
    assert state.step == 2
    assert set(timings) == {"wait_ms", "step_ms", "val_s"}
    assert len(timings["step_ms"]) == 2 and len(timings["val_s"]) == 2
    # with `timings` the tracer was on: each step's four phases under its
    # "step_ms" span, and its batch's load, harvest and upload in the
    # prefetch thread under the step's number
    assert not timing.tracing()
    spans = timing.recorded()["spans"]
    by_index = {s.index: s for s in spans}
    for n in (1, 2):
        mine = {}
        for s in spans:
            if s.batch == n:
                mine.setdefault(s.name, []).append(s)
        lap = by_index[mine["step.forward"][0].parent]
        assert lap.name == "step_ms" and lap.batch == n
        for name in ("step.forward", "step.loss", "step.backward",
                     "step.optimizer"):
            (sp,) = mine[name]
            assert sp.parent == lap.index and sp.thread == lap.thread
        for name in ("load", "harvest", "upload"):
            (sp,) = mine[name]
            assert sp.thread == "prefetch" and sp.parent == -1
        assert mine["load.collate"][0].parent == mine["load"][0].index
        assert mine["harvest.fold"][0].parent == mine["harvest"][0].index
    recs = _records(trainer)
    steps = [r for r in recs if "loss" in r]
    vals = [r for r in recs if "val/AP" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r[k]) for r in steps
               for k in ("loss", "iou_loss", "conf_loss", "cls_loss",
                         "grad_norm", "grad_norm/backbone"))
    assert [r["step"] for r in vals] == [1, 2]
    for name in ("last", "best", "best2"):
        assert os.path.exists(os.path.join(trainer.run_dir,
                                           f"ckpt_{name}.pt")), name
    assert any(float(h.abs().sum()) > 0 for h, _ in state.states)

    fresh = Trainer(cfg, dtype=torch.float32, device="cpu")
    st = fresh.init_state(3)
    before = [p.detach().clone() for p in fresh.det.parameters()]
    st, path = fresh.restore_latest(st)
    assert path is not None and st.step == 2
    for a, b in zip(fresh.det.state_dict().values(),
                    trainer.det.state_dict().values()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, fresh.det.parameters()))
    assert fresh.optimizer.count == trainer.optimizer.count == 2
    st = fresh.fit(max_steps=3, state=st, log_every=1)
    assert st.step == 3


def test_request_stop_checkpoints_and_exits(root, tmp_path):
    cfg = _cfg(experiment_preset, root, tmp_path)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    trainer.request_stop()
    state = trainer.fit(max_steps=50)
    assert state.step == 1
    assert os.path.exists(os.path.join(trainer.run_dir, "ckpt_last.pt"))
    st, path = trainer.restore_latest(trainer.init_state(3))
    assert st.step == 1 and path.endswith("ckpt_last.pt")
    # the request was consumed: the next fit runs to its end
    assert trainer.fit(max_steps=2).step == 2


def test_sigterm_checkpoints_and_exits(root, tmp_path):
    """fit() turns a SIGTERM into a checkpoint at the next step boundary
    and a clean return, then restores the previous handler."""
    cfg = _cfg(experiment_preset, root, tmp_path)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    trainer.logger.add_sink(
        lambda rec: os.kill(os.getpid(), signal.SIGTERM)
        if rec.get("step") == 2 else None)
    before = signal.getsignal(signal.SIGTERM)
    state = trainer.fit(max_steps=20, log_every=1)
    assert state.step == 2
    assert signal.getsignal(signal.SIGTERM) is before
    st, _ = trainer.restore_latest(trainer.init_state(3))
    assert st.step == 2


def test_restore_latest_falls_back_past_a_corrupt_checkpoint(root, tmp_path):
    cfg = _cfg(experiment_preset, root, tmp_path)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    state = trainer.init_state(3)
    trainer.save_checkpoint(state._replace(step=3), "a")
    trainer.save_checkpoint(state._replace(step=9), "b")
    bad = os.path.join(trainer.run_dir, "ckpt_b.pt")
    with open(bad, "r+b") as f:
        f.seek(100)
        f.write(b"\0" * 4096)
    os.utime(bad, (2e9, 2e9))                        # the newest
    assert trainer.latest_checkpoint().endswith("ckpt_a.pt")
    st, path = trainer.restore_latest(state)
    assert st.step == 3 and path.endswith("ckpt_a.pt")


def test_fit_profile_steps_writes_a_trace(root, tmp_path):
    """fit(profile_steps=1) traces step 6 (from step 5) with
    torch.profiler into <run_dir>/profile."""
    cfg = _cfg(experiment_preset, root, tmp_path)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    assert trainer.fit(max_steps=6, profile_steps=1).step == 6
    with open(os.path.join(trainer.run_dir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    trainer.close()


def test_wandb_sink_needs_wandb():
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            MetricLogger.wandb_sink("p")
    else:
        assert callable(MetricLogger.wandb_sink)


def test_metric_logger_sinks(tmp_path):
    got = []
    log = MetricLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.add_sink(got.append)
    log.add_sink(lambda rec: 1 / 0)                  # reported, not raised
    log.log({"step": 1, "loss": torch.tensor(2.5), "x": np.float32(1.5)})
    log.close()
    log.close()
    assert got == [{"step": 1, "loss": 2.5, "x": 1.5}]
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        assert json.loads(f.read()) == got[0]
