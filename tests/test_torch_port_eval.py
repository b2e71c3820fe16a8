"""The port's streaming evaluation against the JAX package's on the CPU:
the eval loader's batches (exactly), the synthetic renderer and the
array-backed sequences (exactly), the Prophesee/COCO evaluator (exactly),
`make_eval_step` at RVT-T and RVT-S widths (1e-4, float32) and
`run_streaming_eval` end to end (AP within 1e-4, every frame's kept
detections), and that the eval entry points need a card unless given
the CPU."""
import os
from dataclasses import replace

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.data import loader as jl
from leod_tpu.data.labels import PROPH_DTYPE
from leod_tpu.data.synthetic import generate_sequence as j_generate_sequence
from leod_tpu.eval.prophesee import PropheseeEvaluator as JEvaluator
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.train.step import make_eval_step as j_make_eval_step
from leod_tpu.train import trainer as jt

from leod_tpu_torch.config import experiment_preset, stem_fold_hw
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.data import loader as tl
from leod_tpu_torch.data.sequence import ArrayEventSequence
from leod_tpu_torch.data.synthetic import (generate_dataset, render_sequence,
                                           render_array_sequences)
from leod_tpu_torch.eval.prophesee import PropheseeEvaluator
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.train import trainer as tt
from leod_tpu_torch.train.step import make_eval_step

from test_torch_port_serve import _randomize, _tiny

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (60, 92)                 # the split's frames; padded to (64, 96)
L = 4
SEED = 5
# (num_reprs, first_label_repr, label_every) of the split's sequences:
# unequal lengths, so that slots run dry at different steps (filler)
SEQS = ((14, 3, 2), (11, 2, 2), (9, 4, 3))


def _cfg(preset, root, size="tiny"):
    cfg = _tiny(preset, size)
    return replace(cfg, dataset=replace(cfg.dataset, path=root,
                                        resolution_hw=HW,
                                        sequence_length=L))


def _seq_kwargs(n, first, every):
    return dict(num_reprs=n, hw=HW, first_label_repr=first,
                label_every=every)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A Gen1-format val split written by the JAX package's generator."""
    root = str(tmp_path_factory.mktemp("gen1"))
    rng = np.random.default_rng(SEED)
    for i, spec in enumerate(SEQS):
        j_generate_sequence(os.path.join(root, "val", f"seq_{i:03d}"), rng,
                            **_seq_kwargs(*spec))
    return root


def _batches(mod, cfg, seqs, batch_size, time_flip, frames_per_slot=2):
    loader = mod.EvalStreamLoader(seqs, cfg.dataset, batch_size,
                                  time_flip=time_flip)
    out = []
    for batch in loader:
        hb = mod.harvest_frames(batch, frames_per_slot, cfg.model.head.max_gt,
                                cfg.model.backbone.in_res_hw,
                                fold_hw=stem_fold_hw(cfg.model))
        out.append((batch, hb))
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (tb, th), (jb, jh) in zip(got, want):
        for k in ("is_first", "is_last", "is_padded", "ev_idx",
                  "is_reversed"):
            assert np.array_equal(tb[k], jb[k]), k
        assert tb["paths"] == jb["paths"]
        for k in ("ev", "is_first", "frame_t", "frame_mask", "labels"):
            assert th[k].dtype == jh[k].dtype and np.array_equal(th[k],
                                                                 jh[k]), k
        for k in ("num_frames", "dropped_frames", "max_slot_frames"):
            assert th[k] == jh[k], k
        for trow, jrow in zip(th["boxes"], jh["boxes"]):
            for tbox, jbox in zip(trow, jrow):
                assert (tbox is None) == (jbox is None)
                if tbox is not None:
                    assert np.array_equal(tbox.arr, jbox.arr)
                    assert tbox.size_hw == jbox.size_hw


@pytest.mark.parametrize("time_flip", [False, True])
@pytest.mark.parametrize("batch_size", [2, 5])
def test_eval_batches_match_jax(split, batch_size, time_flip):
    """Both packages' open_split_sequences + EvalStreamLoader +
    harvest_frames give identical batches; B = 5 exceeds the split's 3
    sequences, so whole slots are filler."""
    tcfg = _cfg(experiment_preset, split)
    jcfg = _cfg(j_experiment_preset, split)
    tseqs = tl.open_split_sequences(tcfg.dataset, "val")
    jseqs = jl.open_split_sequences(jcfg.dataset, "val")
    got = _batches(tl, tcfg, tseqs, batch_size, time_flip)
    want = _batches(jl, jcfg, jseqs, batch_size, time_flip)
    _assert_same_batches(got, want)
    assert any("" in b["paths"] for b, _ in got)        # filler rows
    assert any(h["num_frames"] for _, h in got)


def test_renderer_gives_the_bytes_jax_wrote(split, tmp_path):
    """The port's renderer, from the seed of the split's generator, makes
    the arrays the JAX package wrote; the port's writer writes them back
    in the same layout."""
    cfg = _cfg(experiment_preset, split).dataset
    rng = np.random.default_rng(SEED)
    for i, spec in enumerate(SEQS):
        seq_dir = os.path.join(split, "val", f"seq_{i:03d}")
        ev_dir = os.path.join(seq_dir, "event_representations_v2",
                              cfg.ev_repr_name)
        got = render_sequence(rng, **_seq_kwargs(*spec))
        with h5py.File(os.path.join(ev_dir, "event_representations.h5"),
                       "r") as f:
            want_frames = f["data"][:]
        lab = np.load(os.path.join(seq_dir, "labels_v2", "labels.npz"))
        want_repr = np.load(os.path.join(ev_dir,
                                         "objframe_idx_2_repr_idx.npy"))
        assert got["frames"].dtype == want_frames.dtype
        assert got["frames"].tobytes() == want_frames.tobytes()
        assert got["labels"].tobytes() == lab["labels"].tobytes()
        assert np.array_equal(got["objframe_idx_2_label_idx"],
                              lab["objframe_idx_2_label_idx"])
        assert np.array_equal(got["objframe_idx_2_repr_idx"], want_repr)
    root = generate_dataset(str(tmp_path), num_train=0, num_val=1,
                            num_test=0, seed=SEED, **_seq_kwargs(*SEQS[0]))
    first = render_sequence(np.random.default_rng(SEED),
                            **_seq_kwargs(*SEQS[0]))
    seq = tl.open_split_sequences(replace(cfg, path=root), "val")[0]
    assert np.array_equal(seq.read_ev_repr(0, seq.num_ev_repr),
                          first["frames"])
    seq.close()


@pytest.mark.parametrize("time_flip", [False, True])
def test_array_sequences_give_the_h5_batches(split, time_flip):
    """Sequences held in memory from the renderer give the batches of the
    h5-backed sequences of the same seed (paths aside)."""
    cfg = _cfg(experiment_preset, split)
    rng = np.random.default_rng(SEED)
    mem = []
    for i, spec in enumerate(SEQS):
        s = render_sequence(rng, **_seq_kwargs(*spec))
        mem.append(ArrayEventSequence(
            s["frames"], s["labels"], s["objframe_idx_2_label_idx"],
            s["objframe_idx_2_repr_idx"], cfg.dataset,
            seq_dir=os.path.join(split, "val", f"seq_{i:03d}")))
    disk = tl.open_split_sequences(cfg.dataset, "val")
    _assert_same_batches(_batches(tl, cfg, mem, 2, time_flip),
                         _batches(tl, cfg, disk, 2, time_flip))
    # render_array_sequences draws as generate_dataset does for one split
    same = render_array_sequences(cfg.dataset, 2, seed=1,
                                  **_seq_kwargs(*SEQS[0]))
    rng = np.random.default_rng(1)
    for s in same:
        assert np.array_equal(s.frames, render_sequence(
            rng, **_seq_kwargs(*SEQS[0]))["frames"])


def _eval_streams(rng, n_frames):
    """Per-frame (GT, detections) in PROPH_DTYPE: jittered copies of the
    GT with random scores and classes, spurious boxes, a frame with no
    detections, one with no GT, and one whose GT is filtered (t < 0.5 s)."""
    gts, dts = [], []
    for i in range(n_frames):
        t = 600_000 + 50_000 * i if i != 3 else 200_000
        n_gt = 0 if i == 2 else int(rng.integers(1, 5))
        gt = np.zeros(n_gt, PROPH_DTYPE)
        gt["t"] = t
        gt["x"], gt["y"] = rng.uniform(0, 200, n_gt), rng.uniform(0, 150, n_gt)
        gt["w"], gt["h"] = rng.uniform(12, 90, n_gt), rng.uniform(12, 80, n_gt)
        gt["class_id"] = rng.integers(0, 2, n_gt)
        n_dt = 0 if i == 1 else n_gt + int(rng.integers(0, 4))
        dt = np.zeros(n_dt, PROPH_DTYPE)
        dt["t"] = t
        if n_gt:                          # near a GT box, mostly its class
            src = gt[rng.integers(0, n_gt, n_dt)]
        else:                             # spurious boxes
            src = np.zeros(n_dt, PROPH_DTYPE)
            for k in ("x", "y", "w", "h"):
                src[k] = rng.uniform(10, 100, n_dt)
        for k in ("x", "y", "w", "h"):
            dt[k] = src[k] + rng.normal(0, 4, n_dt)
        dt["w"], dt["h"] = np.abs(dt["w"]) + 5, np.abs(dt["h"]) + 5
        dt["class_id"] = np.where(rng.random(n_dt) < 0.8, src["class_id"],
                                  rng.integers(0, 2, n_dt))
        dt["class_confidence"] = rng.random(n_dt)
        gts.append(gt)
        dts.append(dt)
    return gts, dts


def test_evaluator_matches_jax_exactly():
    gts, dts = _eval_streams(np.random.default_rng(0), 24)
    evs = []
    for cls in (PropheseeEvaluator, JEvaluator):
        whole = cls("gen1", False)
        whole.add_labels(gts)
        whole.add_predictions(dts)
        halves = [cls("gen1", False), cls("gen1", False)]
        for j, h in enumerate(halves):
            h.add_labels(gts[j::2])
            h.add_predictions(dts[j::2])
        evs.append((whole.evaluate(), halves[0].merge(halves[1]).evaluate()))
    (t_whole, t_merged), (j_whole, j_merged) = evs
    assert 0.0 < t_whole["AP"] < 1.0
    assert t_whole == j_whole
    assert t_merged == j_merged
    assert PropheseeEvaluator("gen1", False).evaluate() is None


def _models(size, root):
    jcfg, tcfg = _cfg(j_experiment_preset, root, size), \
        _cfg(experiment_preset, root, size)
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    v = _randomize(jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0))),
                   np.random.default_rng(0))
    tdet = Detector(tcfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(tdet, v)
    return jcfg, tcfg, jdet, v, tdet


@pytest.fixture(scope="module")
def tiny(split):
    return _models("tiny", split)


@pytest.fixture(scope="module")
def small(split):
    return _models("small", split)


def _eval_step_matches_jax(models):
    """Two windows of L = 3 steps at B = 2, M = 2: all rows reset, then
    only the second; preds and the carried states at 1e-4."""
    jcfg, tcfg, jdet, v, tdet = models
    jstep = jax.jit(j_make_eval_step(jdet))
    tstep = make_eval_step(tdet, device="cpu")
    h, w = tcfg.model.backbone.in_res_hw
    c = tcfg.model.backbone.input_channels
    rng = np.random.default_rng(4)
    jst, tst = jdet.init_states(2), tdet.init_states(2)
    for is_first in ([True, True], [False, True]):
        batch = {"ev": np.minimum(rng.poisson(1.0, (3, 2, h // 4, w // 4,
                                                    16 * c)),
                                  255).astype(np.uint8),
                 "is_first": np.asarray(is_first),
                 "frame_t": rng.integers(0, 3, (2, 2)).astype(np.int32)}
        jst, jp = jstep(v, jst, batch)
        tst, tp = tstep(tst, batch)
        assert tp.shape == jp.shape
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        for (th, tc), (jh, jc) in zip(tst, jst):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_eval_step_matches_jax(tiny):
    _eval_step_matches_jax(tiny)


def test_eval_step_matches_jax_rvt_s(small):
    """RVT-S: stages 48/96/192/384 in heads of 24."""
    _eval_step_matches_jax(small)


@pytest.mark.parametrize("case", [
    {}, {"frames_per_slot": 1}, {"max_batches": 3},
    {"time_flip": True, "batch_size": 3}])
def test_run_streaming_eval_matches_jax(tiny, case):
    """The whole slice on the same split and weights at conf 0.001: the
    AP dict within 1e-4, and every harvested frame's GT and kept
    detections (count, class exactly; boxes and scores at 1e-4).
    frames_per_slot=1 forces the harvest budget to regrow."""
    jcfg, tcfg, jdet, v, tdet = tiny
    kw = {"batch_size": 2, "conf_threshold": 0.001, **case}
    t_ev, j_ev = PropheseeEvaluator("gen1", False), JEvaluator("gen1", False)
    got = tt.run_streaming_eval(tdet, tcfg, evaluator=t_ev, device="cpu",
                                **kw)
    want = jt.run_streaming_eval(jdet, v, jcfg, evaluator=j_ev,
                                 shard_index=0, num_shards=1, **kw)
    n = len(j_ev.labels)
    assert len(t_ev.labels) == n > 0
    for i in range(n):
        assert t_ev.labels[i].tobytes() == j_ev.labels[i].tobytes(), i
        tp, jp = t_ev.predictions[i], j_ev.predictions[i]
        assert len(tp) == len(jp), f"frame {i}: {len(tp)} kept, JAX {len(jp)}"
        assert np.array_equal(tp["class_id"], jp["class_id"]), f"frame {i}"
        assert np.array_equal(tp["t"], jp["t"]), f"frame {i}"
        for k in ("x", "y", "w", "h", "class_confidence"):
            np.testing.assert_allclose(tp[k], jp[k], **TOL,
                                       err_msg=f"frame {i} {k}")
    assert sum(len(p) for p in j_ev.predictions) > 0
    assert set(got) == set(want)
    for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_default_frames_per_slot_matches_jax():
    for seq_len in (1, 4, 5, 21, 30):
        for every in (1, 2, 3):
            assert tt.default_frames_per_slot(seq_len, every) == \
                jt.default_frames_per_slot(seq_len, every)
    assert tt.default_frames_per_slot(21) == 6


def test_eval_entry_points_need_a_card_unless_given_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    _, tcfg, _, _, tdet = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(tdet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.run_streaming_eval(tdet, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(tdet, plain=True)
