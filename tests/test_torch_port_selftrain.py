"""The port's self-training against the JAX package's on the CPU.

Exactly (bit-equal arrays, identical files): the host NMS, the pseudo-
label filters, the tracker over seeded detection sequences, the TTA
merge by NMS, `SequenceRecorder.save` and `rerun_track_filter` on the
same labels (an h5-backed split the JAX generator wrote), the
array-backed save against the h5-backed one, `merge_view_preds` and
`_SeqResult`, and `PseudoLabelRunner`'s host half: the JAX runner's
per-batch preds fed to the port's runner through a stub eval step give
a file-identical pseudo dataset and equal `ssod/` metrics, with h-flip
and t-flip on.
End to end, from one set of weights (`load_jax_variables`; prediction
layers scaled up so that the scores spread over (0, 1) and the filters,
the NMS and the tracker do work): the runner's per-batch preds within
1e-4 and each frame's written boxes matched one to one within 1e-3 px
(a box left unmatched must sit within 1e-4 of a threshold or of a top-k
cut, and the failure names which); the shard union equals a full run;
`verify_pseudo_dataset` / `score_pseudo_dataset` within 1e-6 of the JAX
package's, from a directory and from array-backed sequences; and
`run_tta_eval` with h-flip and t-flip: each frame's GT and merged
detections as handed to the evaluator within 1e-4, and AP within 1e-4.
Sizes: embed 32, 64 x 96 input, L 4, B 2, float32."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu import config as jc
from leod_tpu.data.labels import Boxes as JBoxes
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.eval import tta as jtta
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.ops.nms import batched_nms_numpy as j_batched_nms
from leod_tpu.selftrain import filters as jf
from leod_tpu.selftrain import pseudo_labeler as jpl
from leod_tpu.selftrain import runner as jrun
from leod_tpu.selftrain import verify as jver
from leod_tpu.selftrain.tracker import LinearTracker as JTracker

from leod_tpu_torch import config as tc
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.data.sequence import (ArrayEventSequence, EventSequence,
                                          list_sequence_dirs)
from leod_tpu_torch.data.synthetic import render_array_dataset
from leod_tpu_torch.eval import tta as ttta
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.ops.nms import batched_nms_numpy
from leod_tpu_torch.selftrain import filters as tf
from leod_tpu_torch.selftrain import pseudo_labeler as tpl
from leod_tpu_torch.selftrain import runner as trun
from leod_tpu_torch.selftrain import verify as tver
from leod_tpu_torch.selftrain.tracker import LinearTracker

from test_torch_port_serve import _randomize

HW = (64, 96)
L = 4
SPLIT = dict(num_train=4, num_val=3, num_test=0, seed=0, num_reprs=20,
             label_every=4, first_label_repr=3, hw=HW)
OBJ = CLS = 0.01                 # the pseudo-label thresholds
CONF = 0.005                     # the postprocess's obj * cls threshold
TOPK, MAX_DETS = 128, 16
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; torch's
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, root):
    dst = dataclasses.replace(mod.dataset_preset("gen1"), path=root,
                              resolution_hw=HW, sequence_length=L, ratio=0.5)
    model = mod.ModelConfig(
        backbone=mod.BackboneConfig(embed_dim=32, in_res_hw=HW,
                                    partition_size=(2, 3)),
        head=mod.HeadConfig(num_classes=2, max_gt=8),
        postprocess=mod.PostprocessConfig(confidence_threshold=CONF,
                                          max_dets=MAX_DETS,
                                          pre_nms_topk=TOPK))
    return mod.ExperimentConfig(
        dataset=dst, model=model,
        training=mod.TrainingConfig(batch_size_eval=2),
        save_dir=root, exp_name="selftrain")


def _pl(mod, **kw):
    return mod.PseudoLabelConfig(obj_thresh=(OBJ, OBJ), cls_thresh=(CLS, CLS),
                                 min_track_len=2, tta_hflip=True,
                                 tta_tflip=True, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A Gen1-format split written by the JAX generator; both packages'
    configs; the JAX detector and its variables (prediction layers
    scaled up), and the port's detector holding the same weights."""
    root = j_generate_dataset(str(tmp_path_factory.mktemp("gen1")), **SPLIT)
    jcfg, tcfg = _cfg(jc, root), _cfg(tc, root)
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    v = _randomize(jax.tree.map(np.asarray,
                                jdet.init(jax.random.PRNGKey(3))),
                   np.random.default_rng(3))
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, v)
    return root, jcfg, tcfg, jdet, jax.tree.map(jnp.asarray, v), det


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """The JAX runner with h-flip and t-flip: its pseudo dataset, its
    metrics and each batch's preds (what its postprocess was given)."""
    root, jcfg, _, jdet, v, _ = setup
    preds = []
    orig = jrun.postprocess

    def capture(p, **kw):
        preds.append(np.asarray(p))
        return orig(p, **kw)

    jrun.postprocess = capture
    try:
        out = str(tmp_path_factory.mktemp("jax_pseudo"))
        metrics = jrun.PseudoLabelRunner(jdet, v, jcfg, _pl(jpl), out).run()
    finally:
        jrun.postprocess = orig
    return out, metrics, preds


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    """The port's runner end to end, h-flip and t-flip, on the CPU."""
    _, _, tcfg, _, _, det = setup
    preds = []
    out = str(tmp_path_factory.mktemp("port_pseudo"))
    metrics = trun.PseudoLabelRunner(
        det, tcfg, _pl(tpl), out, device="cpu",
        on_batch=lambda pi, bi, hb, p, d, va: preds.append(p.numpy())).run()
    return out, metrics, preds


def _written(root):
    """{sequence: (labels, objframe_idx_2_label_idx, objframe_idx_2_repr_idx,
    h5 link target or None)} of a written pseudo split."""
    out = {}
    for d in list_sequence_dirs(root, "train"):
        ev_dir = os.path.join(d, "event_representations_v2",
                              "stacked_histogram_dt=50_nbins=10")
        z = np.load(os.path.join(d, "labels_v2", "labels.npz"))
        h5 = os.path.join(ev_dir, "event_representations.h5")
        out[os.path.basename(d)] = (
            z["labels"], z["objframe_idx_2_label_idx"],
            np.load(os.path.join(ev_dir, "objframe_idx_2_repr_idx.npy")),
            os.readlink(h5) if os.path.lexists(h5) else None)
    return out


def _assert_same_dataset(got_root, want_root):
    got, want = _written(got_root), _written(want_root)
    assert sorted(got) == sorted(want) and got
    for name in want:
        for g, w in zip(got[name][:3], want[name][:3]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
        assert got[name][3] == want[name][3], name


# ---------------------------------------------------------------------------
# Exact: the host pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_nms_numpy_matches_jax(seed):
    """Overlapping boxes of two classes, with tied scores and duplicate
    boxes: the kept indices of the JAX package's (its native C++ where
    it builds) in order."""
    rng = np.random.default_rng(seed)
    n = 300
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[n // 2:n // 2 + 20] = boxes[:20]               # duplicates
    scores = rng.choice(np.linspace(0.01, 1, 40), n).astype(np.float32)
    ids = rng.integers(0, 2, n).astype(np.float32)
    for thr in (0.3, 0.45, 0.65):
        got = batched_nms_numpy(boxes, scores, ids, thr)
        want = j_batched_nms(boxes, scores, ids, thr)
        assert np.array_equal(got, want), thr
    assert len(batched_nms_numpy(boxes[:0], scores[:0], ids[:0], 0.5)) == 0


def _pred_rows(rng, n):
    """(x1, y1, x2, y2, obj, cls_conf, cls_id) rows, some off the frame,
    some tiny or huge, scores spread over (0, 1)."""
    x1 = rng.uniform(-20, 300, n)
    y1 = rng.uniform(-20, 230, n)
    w = rng.choice([2.0, 8.0, 30.0, 60.0, 290.0], n) * rng.uniform(0.8, 1.2, n)
    h = rng.uniform(3, 80, n)
    return np.stack([x1, y1, x1 + w, y1 + h, rng.uniform(0, 1, n),
                     rng.uniform(0, 1, n), rng.integers(0, 2, n)],
                    -1).astype(np.float32)


def _same_boxes(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert got.arr.dtype == want.arr.dtype
        assert np.array_equal(got.arr, want.arr)
        assert got.size_hw == want.size_hw


def test_filters_match_jax():
    rng = np.random.default_rng(0)
    for L_, ue, re_ in ((21, 2, -1), (21, -1, 3), (5, 1, -1), (10, 4, -1)):
        assert tf.subsample_label_idx(L_, ue, re_) == \
            jf.subsample_label_idx(L_, ue, re_)
    for dataset, ds2 in (("gen1", False), ("gen4", True)):
        rows = _pred_rows(rng, 200)
        g = tf.filter_pred_boxes_xyxy(rows[:, :4], dataset, ds2)
        w = jf.filter_pred_boxes_xyxy(rows[:, :4], dataset, ds2)
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    rows = _pred_rows(rng, 200)
    for thr in (0.5, (0.6, 0.3)):
        assert np.array_equal(
            tf.filter_with_thresholds(rows[:, 4], rows[:, 6], thr),
            jf.filter_with_thresholds(rows[:, 4], rows[:, 6], thr))
    gts, pseudos = [], []
    for i in range(12):
        rows = _pred_rows(rng, int(rng.integers(0, 30)))
        kw = dict(obj_thresh=(0.3, 0.2), cls_thresh=0.25,
                  apply_bbox_filter=i % 3 != 0)
        got = tf.pred_to_label(rows if len(rows) else None, (240, 304), **kw)
        want = jf.pred_to_label(rows if len(rows) else None, (240, 304), **kw)
        _same_boxes(got, want)
        pseudos.append(got)
        gt = tf.pred_to_label(_pred_rows(rng, 5), (240, 304), 0.0, 0.0)
        gt.arr[:, 0] = 50_000
        gts.append(gt if i % 4 else None)
    got_m, got_mask = tf.merge_labels(gts, pseudos)
    want_m, want_mask = jf.merge_labels(gts, pseudos)
    assert got_mask == want_mask
    for a, b in zip(got_m, want_m):
        assert a is b
    mask = [i % 5 != 0 for i in range(12)]
    got = tf.evaluate_pseudo_labels(gts, pseudos, mask, 2, ("car", "ped"),
                                    prefix="p/")
    want = jf.evaluate_pseudo_labels(gts, pseudos, mask, 2, ("car", "ped"),
                                     prefix="p/")
    assert got == want and got


def _det_sequence(rng, n_frames):
    """Per frame: [n, 5] (cx, cy, w, h, class) of objects moving at
    constant velocity (missed now and then, clamped at the frame's edge)
    plus false positives, and a GT flag on every 7th frame."""
    objs = [(rng.uniform(20, 280), rng.uniform(20, 220), rng.uniform(-6, 6),
             rng.uniform(-4, 4), rng.uniform(20, 60), rng.uniform(20, 60),
             float(rng.integers(0, 2))) for _ in range(5)]
    out = []
    for f in range(n_frames):
        rows = []
        for cx, cy, vx, vy, w, h, c in objs:
            if rng.random() < 0.8:
                rows.append([cx + vx * f + rng.normal(0, 1),
                             cy + vy * f + rng.normal(0, 1), w, h, c])
        for _ in range(int(rng.integers(0, 3))):
            rows.append([rng.uniform(0, 304), rng.uniform(0, 240),
                         rng.uniform(10, 50), rng.uniform(10, 50),
                         float(rng.integers(0, 2))])
        dets = np.asarray(rows, np.float64).reshape(-1, 5)
        out.append((dets, np.full(len(dets), f % 7 == 3)))
    return out


def _tracklet_state(trk):
    return (trk.id, trk.bbox.tobytes(), trk.class_id, trk.vxvy.tobytes(),
            tuple(trk.bbox_idx), tuple(trk.all_conf), tuple(trk.all_hits),
            trk.hits, trk.age, trk.done, trk.is_gt,
            tuple((k, v.tobytes())
                  for k, v in sorted(trk.missed_bbox.items())))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_matches_jax(seed):
    """Tracklets, hits, confidences and `missed_bbox` (the inpainting
    records) over a seeded detection sequence with empty frames."""
    seq = _det_sequence(np.random.default_rng(seed), 40)
    got, want = LinearTracker((240, 304)), JTracker((240, 304))
    for f, (dets, is_gt) in enumerate(seq):
        if f % 11 == 5:
            dets, is_gt = np.zeros((0, 5)), np.zeros(0, bool)
        got.update(f, dets, is_gt)
        want.update(f, dets, is_gt)
    got.finish()
    want.finish()
    assert got.bbox_count == want.bbox_count > 0
    assert [_tracklet_state(t) for t in got.finished] == \
        [_tracklet_state(t) for t in want.finished]
    assert any(t.missed_bbox for t in got.finished)
    for bi in range(got.bbox_count):
        assert got.tracklet_of_bbox(bi).id == want.tracklet_of_bbox(bi).id


def _frame_labels(rng, n_frames, hw=(240, 304), gt_every=5):
    """Per frame the port's pseudo label (`pred_to_label` of moving, noisy
    boxes with scores in (0.05, 1)), a GT label every `gt_every`-th."""
    out = []
    for f, (dets, _) in enumerate(_det_sequence(rng, n_frames)):
        rows = np.zeros((len(dets), 7), np.float32)
        rows[:, :2] = dets[:, :2] - dets[:, 2:4] / 2
        rows[:, 2:4] = dets[:, :2] + dets[:, 2:4] / 2
        rows[:, 4:6] = rng.uniform(0.05, 1, (len(dets), 2))
        rows[:, 6] = dets[:, 4]
        lab = tf.pred_to_label(rows, hw, OBJ, CLS)
        if f % gt_every == 0 and len(lab):
            lab.arr[:, 0] = (f + 1) * 50_000               # GT: t != 0
        out.append(lab)
    return out


def _as_jax(labels):
    return [None if l is None else JBoxes(l.arr.copy(), l.size_hw)
            for l in labels]


def test_tta_merge_nms_matches_jax():
    rng = np.random.default_rng(4)
    labs = [None if i % 9 == 4 else (l.concat(l) if i % 2 else l)
            for i, l in enumerate(_frame_labels(rng, 30))]
    jlabs = _as_jax(labs)
    for conf, thr in ((0.005, 0.45), (0.2, 0.6)):
        got = tpl.tta_merge_nms(labs, conf, thr)
        want = jpl.tta_merge_nms(jlabs, conf, thr)
        for g, w in zip(got, want):
            _same_boxes(g, w)


def _record(mod, seq_dir, labels, cfg, source=None):
    """A recorder fed one sequence's frames in two TTA views (the second
    h-flipped) and a time-flipped pass."""
    kw = {} if source is None else {"source": source}
    rec = mod.SequenceRecorder(seq_dir, 1.0, _pl(mod), cfg.model.postprocess,
                               **kw)
    n = len(labels)
    idx = list(range(n))
    for is_h in (False, True):
        rec.update([l if not is_h or l is None else
                    (l.flip_lr() if l.is_pseudo().all() else None)
                    for l in labels], idx, True, [False] * n,
                   is_hflip=is_h, is_tflip=False, tflip_offset=-1)
    rec.update([None if l is None or l.is_gt().any() else l for l in labels],
               [i + 1 for i in idx[:-1]] + [-1], True, [False] * n,
               is_hflip=False, is_tflip=True, tflip_offset=-1)
    return rec


def test_recorder_save_and_rerun_track_filter_match_jax(setup, tmp_path):
    """The same labels through both packages' recorders (h-flip and
    t-flip views, the tracker filter, inpainting) give identical files;
    so does `rerun_track_filter` over the written split."""
    root, jcfg, tcfg, _, _, _ = setup
    rng = np.random.default_rng(7)
    for seq_dir in list_sequence_dirs(root, "train"):
        n = EventSequence(seq_dir, tcfg.dataset).num_ev_repr
        labels = _frame_labels(rng, n)
        jlabels = _as_jax(labels)
        _record(tpl, seq_dir, labels, tcfg).save(str(tmp_path / "t"),
                                                 tcfg.dataset)
        _record(jpl, seq_dir, jlabels, jcfg).save(str(tmp_path / "j"),
                                                  jcfg.dataset)
    _assert_same_dataset(str(tmp_path / "t"), str(tmp_path / "j"))
    w = _written(str(tmp_path / "t"))
    lab = np.concatenate([v[0] for v in w.values()])
    assert (lab["class_id"] == 1024).any() and (lab["t"] != 0).any()
    assert ((lab["class_id"] == 1024) & (lab["objectness"] == 0)).any()
    for split in ("val",):
        assert os.path.islink(str(tmp_path / "t" / split))
    pl_t = dataclasses.replace(_pl(tpl), min_track_len=4)
    pl_j = dataclasses.replace(_pl(jpl), min_track_len=4)
    assert tpl.rerun_track_filter(str(tmp_path / "t"), str(tmp_path / "t2"),
                                  tcfg.dataset, pl_t) == \
        jpl.rerun_track_filter(str(tmp_path / "j"), str(tmp_path / "j2"),
                               jcfg.dataset, pl_j) == SPLIT["num_train"]
    _assert_same_dataset(str(tmp_path / "t2"), str(tmp_path / "j2"))


def test_array_backed_save_matches_h5(setup, tmp_path):
    """A recorder whose source is an `ArrayEventSequence` (the rendered
    bytes of the split) writes the labels and index map the h5-backed
    one writes, links no h5, and `load_pseudo_sequences` serves them
    with the source's frames."""
    root, _, tcfg, _, _, _ = setup
    arrays = render_array_dataset(tcfg.dataset, **SPLIT)["train"]
    rng = np.random.default_rng(8)
    for seq_dir, src in zip(list_sequence_dirs(root, "train"), arrays):
        assert os.path.basename(seq_dir) == os.path.basename(src.seq_dir)
        labels = _frame_labels(rng, src.num_ev_repr)
        copy = [None if l is None else l.copy() for l in labels]
        _record(tpl, seq_dir, labels, tcfg).save(str(tmp_path / "h5"),
                                                 tcfg.dataset)
        _record(tpl, src.seq_dir, copy, tcfg, source=src).save(
            str(tmp_path / "arr"), tcfg.dataset)
    got, want = _written(str(tmp_path / "arr")), _written(str(tmp_path / "h5"))
    assert sorted(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name][:3], want[name][:3]):
            assert g.tobytes() == w.tobytes(), name
        assert got[name][3] is None and want[name][3] is not None
    seqs = tpl.load_pseudo_sequences(str(tmp_path / "arr"), arrays,
                                     tcfg.dataset)
    disk = tpl.load_pseudo_sequences(str(tmp_path / "h5"),
                                     [EventSequence(d, tcfg.dataset)
                                      for d in list_sequence_dirs(root,
                                                                  "train")],
                                     tcfg.dataset)
    assert len(seqs) == len(disk) == SPLIT["num_train"]
    for a, d in zip(seqs, disk):
        assert isinstance(a, ArrayEventSequence)
        assert a.kept_objframe_idx == d.kept_objframe_idx
        assert np.array_equal(a.read_ev_repr(0, a.num_ev_repr),
                              d.read_ev_repr(0, d.num_ev_repr))
        for i in range(len(a.frame_labels)):
            assert np.array_equal(a.frame_labels[i].arr,
                                  d.frame_labels[i].arr)
        d.close()


def test_merge_view_preds_and_seq_result_match_jax():
    rng = np.random.default_rng(5)
    pp_t = tc.PostprocessConfig(confidence_threshold=0.05)
    pp_j = jc.PostprocessConfig(confidence_threshold=0.05)
    for n in (0, 5, 60):
        rows = _pred_rows(rng, n)
        assert np.array_equal(ttta.merge_view_preds(rows, pp_t),
                              jtta.merge_view_preds(rows, pp_j))
    got, want = ttta._SeqResult(304.0), jtta._SeqResult(304.0)
    gt = tf.pred_to_label(_pred_rows(rng, 4), (240, 304), 0.0, 0.0)
    for i, (h, t) in enumerate(((False, False), (True, False),
                                (False, True), (True, True))):
        rows = _pred_rows(rng, 7)
        for r in (got, want):
            r.add(10 + i % 2, gt if i == 0 else None, rows, h, t, -1)
    assert got.augmented and want.augmented
    assert sorted(got.preds) == sorted(want.preds)
    for k in want.preds:
        for a, b in zip(got.preds[k], want.preds[k]):
            assert np.array_equal(a, b)
    assert list(got.gts) == list(want.gts)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def test_runner_host_half_matches_jax(setup, jax_run, tmp_path, monkeypatch):
    """The JAX runner's per-batch preds fed to the port's runner through
    a stub eval step: the same pseudo dataset, file for file, and the
    same `ssod/` metrics."""
    _, _, tcfg, _, _, det = setup
    want_dir, want_metrics, preds = jax_run
    feed = iter(preds)

    def stub_eval_step(det_, plain=False, device="cpu"):
        return lambda states, batch: (states,
                                      torch.from_numpy(next(feed).copy()))

    monkeypatch.setattr(trun, "make_eval_step", stub_eval_step)
    got_metrics = trun.PseudoLabelRunner(det, tcfg, _pl(tpl),
                                         str(tmp_path / "p"),
                                         device="cpu").run()
    assert next(feed, None) is None
    _assert_same_dataset(str(tmp_path / "p"), want_dir)
    assert got_metrics == want_metrics
    assert any(k.startswith("ssod/teacher_AP") for k in got_metrics)


def _frames(root):
    """{(sequence, repr index): labels rows} of a written pseudo split."""
    out = {}
    for name, (lab, f2l, f2r, _) in _written(root).items():
        ends = list(f2l[1:]) + [len(lab)]
        for r, a, b in zip(f2r, f2l, ends):
            out[(name, int(r))] = lab[a:b]
    return out


def _near_cut(row, kept_scores):
    """Which cut an unmatched box sits within TOL of, or None."""
    obj, cls = float(row["objectness"]), float(row["class_confidence"])
    if abs(obj - OBJ) <= TOL or abs(cls - CLS) <= TOL:
        return "obj/cls threshold"
    if abs(obj * cls - CONF) <= TOL:
        return "confidence threshold"
    if any(abs(obj * cls - s) <= TOL for s in kept_scores):
        return "top-k cut"
    return None


def test_runner_end_to_end_matches_jax(jax_run, port_run):
    """The port's runner against the JAX one from the same weights: each
    batch's preds within 1e-4, and each frame's written boxes matched
    one to one (same class, t and scores within 1e-4, coordinates within
    1e-3 px); a box left unmatched must sit within 1e-4 of a cut."""
    jdir, jmetrics, jpreds = jax_run
    tdir, tmetrics, tpreds = port_run
    assert len(tpreds) == len(jpreds) > 0
    for g, w in zip(tpreds, jpreds):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    got, want = _frames(tdir), _frames(jdir)
    unmatched = []
    n_boxes = 0
    for key in sorted(set(got) | set(want)):
        g = got.get(key, np.zeros(0, want[next(iter(want))].dtype))
        w = want.get(key, np.zeros(0, g.dtype))
        n_boxes += len(w)
        used = np.zeros(len(g), bool)
        for wr in w:
            ok = [i for i in range(len(g)) if not used[i]
                  and g[i]["class_id"] == wr["class_id"]
                  and g[i]["t"] == wr["t"]
                  and all(abs(float(g[i][k]) - float(wr[k])) <= 1e-3
                          for k in ("x", "y", "w", "h"))
                  and all(abs(float(g[i][k]) - float(wr[k])) <= TOL
                          for k in ("objectness", "class_confidence"))]
            if ok:
                used[ok[0]] = True
            else:
                unmatched.append(("jax", key, wr))
        unmatched += [("port", key, g[i]) for i in np.flatnonzero(~used)]
    assert n_boxes > 50
    for who, key, row in unmatched:
        scores = [float(r["objectness"] * r["class_confidence"])
                  for r in (got if who == "jax" else want).get(key, [])]
        assert _near_cut(row, scores), (
            f"{who}'s box at {key} is matched nowhere and sits at no cut: "
            f"{row}")
    assert sorted(tmetrics) == sorted(jmetrics)
    counts = np.concatenate([v[0] for v in _written(tdir).values()])
    assert (counts["class_id"] == 1024).any() and \
        ((counts["t"] == 0) & (counts["class_id"] != 1024)).any()


def test_runner_shard_union_equals_full_run(setup, port_run, tmp_path):
    _, _, tcfg, _, _, det = setup
    for si in range(2):
        trun.PseudoLabelRunner(det, tcfg, _pl(tpl), str(tmp_path),
                               shard_index=si, num_shards=2,
                               device="cpu").run()
    _assert_same_dataset(str(tmp_path), port_run[0])
    with pytest.raises(AssertionError, match="already exists"):
        trun.PseudoLabelRunner(det, tcfg, _pl(tpl), str(tmp_path),
                               device="cpu").run()


def test_verify_and_score_match_jax(setup, jax_run):
    """On the JAX runner's pseudo dataset: `verify_pseudo_dataset` and
    `score_pseudo_dataset` from the split's directory and from the
    array-backed sequences, against the JAX package's (1e-6)."""
    root, jcfg, tcfg, _, _, _ = setup
    jdir = jax_run[0]
    arrays = render_array_dataset(tcfg.dataset, **SPLIT)["train"]
    n = jver.verify_pseudo_dataset(jdir, jcfg.dataset, sample_frac=1.0)
    assert n == SPLIT["num_train"]
    assert tver.verify_pseudo_dataset(jdir, tcfg.dataset,
                                      sample_frac=1.0) == n
    assert tver.verify_pseudo_dataset(jdir, tcfg.dataset, sample_frac=1.0,
                                      sequences=arrays) == n
    want = jver.score_pseudo_dataset(jdir, jcfg.dataset, _pl(jpl), 2,
                                     jcfg.dataset.classes)
    assert want
    for kw in ({}, {"sequences": arrays}):
        got = tver.score_pseudo_dataset(jdir, tcfg.dataset, _pl(tpl), 2,
                                        tcfg.dataset.classes, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def _capture_frames(monkeypatch, mod):
    """Record what `mod.run_tta_eval` hands its evaluator: each frame's
    GT (Prophesee rows) and merged detections, in the order added."""
    frames = []
    orig = mod.boxes_to_prophesee

    def capture(gt, merged, *a, **kw):
        gt_p, dt_p = orig(gt, merged, *a, **kw)
        rows = (np.zeros((0, 7), np.float32) if merged is None
                else np.array(merged, np.float32))
        frames.append((gt_p, rows))
        return gt_p, dt_p

    monkeypatch.setattr(mod, "boxes_to_prophesee", capture)
    return frames


def _by_score(rows):
    return rows[np.lexsort((rows[:, 0], -rows[:, 4] * rows[:, 5]))]


def test_tta_eval_matches_jax(setup, monkeypatch):
    """`run_tta_eval` with h-flip and t-flip on the val split. What each
    package hands its evaluator is held frame by frame: the same GT
    frames in the same order (so GT comes from the unflipped pass at the
    same `ev_idx`), and each frame's merged detections, h-flipped and
    t-flipped views mapped back and NMS-merged, row for row within 1e-4
    (a row left over must sit within 1e-4 of the confidence cut). Then
    AP within 1e-4 of the JAX package's; and with explicit shards the
    merged evaluators equal the full run."""
    _, jcfg, tcfg, jdet, v, det = setup
    from leod_tpu_torch.eval.prophesee import PropheseeEvaluator
    kw = dict(split="val", hflip=True, tflip=True, batch_size=2)
    jframes = _capture_frames(monkeypatch, jtta)
    tframes = _capture_frames(monkeypatch, ttta)
    want = jtta.run_tta_eval(jdet, v, jcfg, **kw)
    kept = []
    got = ttta.run_tta_eval(det, tcfg, device="cpu",
                            on_batch=lambda pi, bi, hb, p, d, va:
                            kept.append((pi, int(va.sum()))), **kw)
    assert len(tframes) == len(jframes) > 0
    n_rows = 0
    for (tgt, trows), (jgt, jrows) in zip(tframes, jframes):
        assert tgt.tolist() == jgt.tolist()
        g, w = _by_score(trows), _by_score(jrows)
        n = min(len(g), len(w))
        np.testing.assert_allclose(g[:n], w[:n], rtol=0, atol=TOL)
        for r in (g[n:] if len(g) > n else w[n:]):
            assert abs(float(r[4] * r[5]) - CONF) <= TOL, (
                f"a merged row at t={jgt['t'][0]} matched nowhere: {r}")
        n_rows += len(w)
    assert n_rows > 50
    monkeypatch.undo()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    # both passes ran, and boxes reached the merge
    assert {pi for pi, _ in kept} == {0, 1} and sum(n for _, n in kept)
    evs = []
    for si in range(2):
        ev = PropheseeEvaluator(tcfg.dataset.name, False)
        assert ttta.run_tta_eval(det, tcfg, device="cpu", shard_index=si,
                                 num_shards=2, evaluator=ev, **kw) is None
        evs.append(ev)
    merged = evs[0].merge(evs[1]).evaluate()
    for k in got:
        assert merged[k] == pytest.approx(got[k], abs=1e-12), k


def test_entry_points_need_a_card_unless_given_the_cpu(setup, tmp_path):
    _, _, tcfg, _, _, det = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.PseudoLabelRunner(det, tcfg, _pl(tpl), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttta.run_tta_eval(det, tcfg, "val")
