"""Gen4 (1 Mpx) through the port against the JAX package on the CPU, in
float32 at RVT-T widths: the Gen4 preset (3 classes, the x2 downsampled
`_ds2_nearest` frames, partition split 2, `tflip_offset` -2) at a
reduced `resolution_hw` of 384 x 640, whose derived input is 192 x 320
in a 3 x 5 partition (T = 15 tokens a window; stage maps 48 x 80 down
to 6 x 10), on a ds2 split with 3 classes written by the JAX package's
generator:

- `run_streaming_eval` of both packages: every batch's preds within
  1e-4, the evaluator's inputs (GT exactly; each kept detection matched
  one to one, class exactly, box and score within 1e-4), and AP within
  1e-4, with Gen4's evaluator (its ds2 box filter);
- one train step at remat "stage1" against `leod_tpu`'s
  `make_train_step`: the loss and its components within 1e-4, every
  gradient within 1e-4 of its tensor's largest;
- `PseudoLabelRunner` with h-flip and t-flip (its window shifted by
  Gen4's offset): both packages' runners fed the same seeded preds
  through stub eval steps write the same pseudo dataset, array for
  array, and report the same `ssod/` metrics."""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu import config as jc
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.eval.prophesee import PropheseeEvaluator as JEvaluator
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.selftrain import pseudo_labeler as jpl
from leod_tpu.selftrain import runner as jrun
from leod_tpu.train import step as jstep
from leod_tpu.train import trainer as jt

from leod_tpu_torch import config as tc
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.eval.prophesee import PropheseeEvaluator
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.selftrain import pseudo_labeler as tpl
from leod_tpu_torch.selftrain import runner as trun
from leod_tpu_torch.train import step as tstep
from leod_tpu_torch.train import trainer as tt
from leod_tpu_torch.train.optim import make_optimizer

from test_torch_port_serve import _randomize
from test_torch_port_train_step import (TOL, _capture_grads, _close,
                                        _each_tensor)

RESOLUTION = (384, 640)          # full-resolution labels; frames at half
L = 5                            # Gen4's sequence_length
SPLIT = dict(num_train=3, num_val=3, num_test=0, seed=0, num_reprs=15,
             label_every=2, first_label_repr=3, hw=RESOLUTION, ds2=True,
             num_classes=3)
OBJ = CLS = 0.01                 # the pseudo-label thresholds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; torch's
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, root):
    """The Gen4 preset at RVT-T widths and RESOLUTION, derived again."""
    cfg = mod.experiment_preset("gen4", "tiny")
    dst = replace(cfg.dataset, path=root, resolution_hw=RESOLUTION,
                  sequence_length=L, ratio=0.5)
    training = replace(cfg.training, batch_size_eval=2,
                       gradient_clip_val=0.0)
    return mod.derive(replace(cfg, dataset=dst, training=training))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = j_generate_dataset(str(tmp_path_factory.mktemp("gen4")), **SPLIT)
    jcfg, tcfg = _cfg(jc, root), _cfg(tc, root)
    bb = tcfg.model.backbone
    assert (bb.in_res_hw, bb.partition_size) == ((192, 320), (3, 5))
    assert tcfg.model.head.num_classes == 3
    assert tcfg.dataset.downsample_by_factor_2
    assert tcfg.dataset.tflip_offset == -2
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0)))
    return root, jcfg, tcfg, jdet, init


def _assert_same_detections(got, want, what):
    """Each kept detection matched one to one: the same time and class,
    box and score within 1e-4 (relative above one). Kept detections
    whose sort keys lie within rounding of each other may come in
    either order."""
    fields = ("x", "y", "w", "h", "class_confidence")
    g = np.stack([got[k] for k in fields], -1).astype(np.float64)
    w = np.stack([want[k] for k in fields], -1).astype(np.float64)
    free = np.ones(len(want), bool)
    for i in range(len(got)):
        close = np.all(np.abs(g[i] - w) <= 1e-4 * np.maximum(1.0, np.abs(w)),
                       axis=-1)
        hit = np.nonzero(free & close & (want["class_id"] == got["class_id"][i])
                         & (want["t"] == got["t"][i]))[0]
        assert len(hit), f"{what}: detection {i} {got[i]} has no match"
        free[hit[0]] = False


def test_streaming_eval_matches_jax(setup, monkeypatch):
    root, jcfg, tcfg, jdet, init = setup
    v = _randomize(init, np.random.default_rng(0))
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, v)
    preds = {"port": [], "jax": []}
    for mod, key in ((tt, "port"), (jt, "jax")):
        orig = mod.postprocess

        def capture(p, *a, orig=orig, key=key, **kw):
            preds[key].append(np.asarray(p))
            return orig(p, *a, **kw)

        monkeypatch.setattr(mod, "postprocess", capture)
    t_ev = PropheseeEvaluator("gen4", True)
    j_ev = JEvaluator("gen4", True)
    kw = dict(batch_size=2, conf_threshold=0.001)
    got = tt.run_streaming_eval(det, tcfg, evaluator=t_ev, device="cpu",
                                **kw)
    want = jt.run_streaming_eval(jdet, jax.tree.map(jnp.asarray, v), jcfg,
                                 evaluator=j_ev, shard_index=0, num_shards=1,
                                 **kw)
    assert len(preds["port"]) == len(preds["jax"]) > 0
    for a, b in zip(preds["port"], preds["jax"]):
        assert a.shape == b.shape and a.shape[-1] == 5 + 3
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    n = len(j_ev.labels)
    assert len(t_ev.labels) == n > 0
    for i in range(n):
        assert t_ev.labels[i].tobytes() == j_ev.labels[i].tobytes(), i
        tp, jp = t_ev.predictions[i], j_ev.predictions[i]
        assert len(tp) == len(jp), f"frame {i}: {len(tp)} kept, JAX {len(jp)}"
        _assert_same_detections(tp, jp, f"frame {i}")
    assert sum(len(p) for p in j_ev.predictions) > 0
    assert {int(c) for lab in j_ev.labels for c in lab["class_id"]} \
        == {0, 1, 2}
    assert set(got) == set(want)
    for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def _train_batch(cfg, b=2, m=2, g=6, seed=1):
    """A prefolded uint8 window, 3-class boxes on every frame kept, a
    padded frame slot, one row starting a sequence."""
    rng = np.random.default_rng(seed)
    h, w = cfg.model.backbone.in_res_hw
    c = cfg.model.backbone.input_channels
    ev = np.minimum(rng.poisson(1.5, (L, b, h // 4, w // 4, 16 * c)),
                    255).astype(np.uint8)
    labels = np.zeros((b, m, g, 7), np.float32)
    for i in range(b):
        for j in range(m):
            for k in range(int(rng.integers(2, g))):
                bw, bh = rng.uniform(12, 60, 2)
                labels[i, j, k] = [rng.integers(0, 3),
                                   rng.uniform(bw / 2, w - bw / 2),
                                   rng.uniform(bh / 2, h - bh / 2),
                                   bw, bh, 1.0, 1.0]
    frame_mask = np.array([[True, True], [True, False]])
    labels[~frame_mask] = 0.0
    return dict(ev=ev, is_first=np.array([True, False]),
                frame_t=np.array([[1, 4], [3, 4]], np.int32),
                frame_mask=frame_mask, labels=labels)


def test_train_step_stage1_matches_jax(setup):
    _, jcfg, tcfg, jdet, init = setup
    v = _randomize(init, np.random.default_rng(1))
    v["params"]["head"] = init["params"]["head"]
    v["batch_stats"]["head"] = init["batch_stats"]["head"]
    batch = _train_batch(tcfg)
    tx = _capture_grads()
    jv = jax.tree.map(jnp.asarray, v)
    state = jstep.TrainState(variables=jv, opt_state=tx.init(jv["params"]),
                             states=jdet.init_states(2, jnp.float32),
                             step=jnp.zeros((), jnp.int32))
    jst, jm = jax.jit(jstep.make_train_step(jdet, tx, remat="stage1"))(
        state, {k: jnp.asarray(x) for k, x in batch.items()})
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, v)
    opt, _ = make_optimizer(tcfg.training, det.parameters())
    _, tm = tstep.make_train_step(det, opt, remat="stage1")(
        tstep.TrainState(states=det.init_states(2), step=0), batch)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    assert float(jm["num_fg"]) > 0
    n = 0
    for path, want, got in _each_tensor(
            det, jax.tree.map(np.asarray, jst.opt_state), "grad",
            lambda t: t.grad.numpy()):
        _close(got, want, path)
        n += 1
    assert n == len(list(det.parameters()))


def _seeded_preds(cfg, seed):
    """A stub eval step's preds, [B*M, A, 5 + 3] decoded boxes with
    sigmoided scores, drawn from `seed` and the call's count; the list
    of the calls' frame counts."""
    h, w = cfg.model.backbone.in_res_hw
    calls = []

    def preds(n_frames):
        rng = np.random.default_rng((seed, len(calls)))
        calls.append(n_frames)
        n_anchors = sum((h // s) * (w // s) for s in cfg.model.head.strides)
        p = np.empty((n_frames, n_anchors, 8), np.float32)
        p[..., 0] = rng.uniform(0, w, p.shape[:2])
        p[..., 1] = rng.uniform(0, h, p.shape[:2])
        p[..., 2:4] = rng.uniform(8, 80, p.shape[:2] + (2,))
        # about 1 % of the anchors hold an object
        obj = rng.uniform(0, 1, p.shape[:2]) < 0.01
        p[..., 4] = np.where(obj, rng.uniform(0.2, 1.0, p.shape[:2]),
                             rng.uniform(0.0, 0.005, p.shape[:2]))
        p[..., 5:] = rng.uniform(0, 1, p.shape[:2] + (3,))
        return p

    return preds, calls


def _written(root):
    """{sequence: {array name: array}, and the event link's target} of a
    written pseudo split."""
    out = {}
    train = os.path.join(root, "train")
    for name in sorted(os.listdir(train)):
        arrays = {}
        for d, _, files in os.walk(os.path.join(train, name)):
            for f in sorted(files):
                path = os.path.join(d, f)
                rel = os.path.relpath(path, train)
                if os.path.islink(path):
                    arrays[rel] = os.readlink(path)
                elif f.endswith(".npz"):
                    with np.load(path) as z:
                        arrays.update((f"{rel}:{k}", z[k]) for k in z.files)
                elif f.endswith(".npy"):
                    arrays[rel] = np.load(path)
        out[name] = arrays
    return out


def test_pseudo_label_routing_matches_jax(setup, tmp_path, monkeypatch):
    root, jcfg, tcfg, jdet, init = setup
    t_preds, t_calls = _seeded_preds(tcfg, 7)
    j_preds, j_calls = _seeded_preds(jcfg, 7)

    def t_step(det_, plain=False, device="cpu"):
        return lambda states, hb: (
            states, torch.from_numpy(t_preds(hb["frame_t"].size)))

    monkeypatch.setattr(trun, "make_eval_step", t_step)
    monkeypatch.setattr(jrun, "cached_eval_step", lambda det_: (
        lambda variables, states, hb: (states, j_preds(hb["frame_t"].size))))
    pl = dict(obj_thresh=(OBJ,) * 3, cls_thresh=(CLS,) * 3, min_track_len=2,
              tta_hflip=True, tta_tflip=True)
    # the runner's NMS at the self-training tests' small budget
    pp = dict(pre_nms_topk=128, max_dets=16)
    tcfg = replace(tcfg, model=replace(tcfg.model, postprocess=replace(
        tcfg.model.postprocess, **pp)))
    jcfg = replace(jcfg, model=replace(jcfg.model, postprocess=replace(
        jcfg.model.postprocess, **pp)))
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu")
    got_metrics = trun.PseudoLabelRunner(
        det, tcfg, tpl.PseudoLabelConfig(**pl), str(tmp_path / "port"),
        device="cpu").run()
    want_metrics = jrun.PseudoLabelRunner(
        jdet, None, jcfg, jpl.PseudoLabelConfig(**pl),
        str(tmp_path / "jax")).run()
    # two passes (forward, then time-flipped), each of batches of
    # batch_size_eval = 2 slots doubled by the h-flip
    assert t_calls == j_calls and len(t_calls) >= 2
    assert all(n == 2 * 2 * L for n in t_calls)
    got, want = _written(str(tmp_path / "port")), _written(
        str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == ["seq_000", "seq_001", "seq_002"]
    n_boxes = 0
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for k, w in want[name].items():
            g = got[name][k]
            if isinstance(w, str):
                assert g == w, (name, k)
            else:
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                    (name, k)
                if k.endswith(":labels"):
                    n_boxes += len(w)
    assert n_boxes > 0
    assert got_metrics == want_metrics
