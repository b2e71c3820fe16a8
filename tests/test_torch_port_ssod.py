"""The port's soft student and online SSOD against the JAX package's on
the CPU: the SSOD stream loader's paired weak/strong batches byte for
byte (with their transform records), `make_teacher_update` (EMA with the
true-average warm-up, and every-N) within 1e-7 over three steps on the
model's variables, `OnlineSSODBatcher._merge` exactly on the same
detections and pairs, one soft-student train step on a written pseudo
split (ignore-labelled, inpainted and low-confidence pseudo boxes; the
loss within 1e-4, the gradient within 1e-5 of `jax.grad`'s in l2 norm
over all parameters, and each tensor elementwise within 1e-4 of its
largest), and the port's own `Trainer.fit` under
`ssod_online`: the burn-in, the teacher moving by the EMA at every step,
and the burn-in counter seeded from a restored step. Sizes: RVT-T
widths, 64 x 96 input, L 4, B 2, float32."""
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu import config as jc
from leod_tpu.data import loader as jl
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.selftrain import online as jon
from leod_tpu.train import step as jstep

from leod_tpu_torch import config as tc
from leod_tpu_torch.config import stem_fold_hw
from leod_tpu_torch.convert import _leaves, _target, load_jax_variables
from leod_tpu_torch.data import loader as tl
from leod_tpu_torch.data.sequence import EventSequence, list_sequence_dirs
from leod_tpu_torch.data.synthetic import render_array_dataset
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.selftrain import online as ton
from leod_tpu_torch.selftrain import pseudo_labeler as tpl
from leod_tpu_torch.train.optim import make_optimizer
from leod_tpu_torch.train.step import TrainState, make_train_step
from leod_tpu_torch.train.trainer import Trainer

from test_torch_port_selftrain import _frame_labels, _record
from test_torch_port_serve import _randomize
from test_torch_port_train_loop import _same_batch
from test_torch_port_train_step import _capture_grads, _each_tensor, _j_state

HW = (64, 96)
L, B = 4, 2
SPLIT = dict(num_train=2, num_val=1, num_test=0, seed=1, num_reprs=24,
             label_every=4, first_label_repr=3, hw=HW)
AUG = dict(prob_hflip=0.5, prob_tflip=0.5, rotate_prob=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the machine's cores; torch's
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, root, soft=False, **ssod):
    """RVT-T widths at 64 x 96, L 4, B 2, the preset's augmentations
    with every kind on, online SSOD as given."""
    cfg = mod.experiment_preset("gen1", "tiny", soft=soft)
    bb = replace(cfg.model.backbone, in_res_hw=HW, partition_size=(2, 3))
    zoom = replace(cfg.dataset.augment_stream.zoom, prob=0.9)
    dst = replace(cfg.dataset, path=root, resolution_hw=HW,
                  sequence_length=L, ratio=0.5,
                  augment_stream=replace(cfg.dataset.augment_stream,
                                         zoom=zoom, **AUG))
    pp = replace(cfg.model.postprocess, confidence_threshold=0.005,
                 max_dets=16, pre_nms_topk=128)
    tr = replace(cfg.training, batch_size_train=B, batch_size_eval=B,
                 val_check_interval=0, max_det_frames=L,
                 ssod_online=replace(cfg.training.ssod_online, **ssod))
    return replace(cfg, dataset=dst, training=tr, save_dir=root,
                   exp_name="ssod",
                   model=replace(cfg.model, backbone=bb, postprocess=pp))


SSOD = dict(enabled=True, burn_in_steps=1, obj_thresh=0.05, cls_thresh=0.05,
            skip_first_t=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return j_generate_dataset(str(tmp_path_factory.mktemp("gen1")), **SPLIT)


@pytest.fixture(scope="module")
def weights():
    """JAX variables at RVT-T widths with the prediction layers scaled
    up (scores spread over (0, 1), so that a teacher emits boxes)."""
    jdet = JDetector(_cfg(jc, "").model, dtype=jnp.float32)
    return _randomize(jax.tree.map(np.asarray,
                                   jdet.init(jax.random.PRNGKey(1))),
                      np.random.default_rng(1))


def _pairs(mod, cfg, n, seed=0):
    seqs = mod.open_split_sequences(cfg.dataset, "train")
    it = iter(mod.StreamTrainLoader(seqs, cfg.dataset, B, seed, ssod=True))
    return [next(it) for _ in range(n)]


def test_ssod_loader_pairs_match_jax(root):
    """Both packages' `StreamTrainLoader(ssod=True)` from one seed: the
    weak and strong batches byte for byte, and the weak view's
    parameters and the strong view's applied transforms."""
    got = _pairs(tl, _cfg(tc, root), 4)
    want = _pairs(jl, _cfg(jc, root), 4)
    strong_zoom = False
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["strong", "strong_applied", "weak",
                                          "weak_params"]
        _same_batch(g["weak"], w["weak"])
        _same_batch(g["strong"], w["strong"])
        for key in ("weak_params", "strong_applied"):
            assert [asdict(p) for p in g[key]] == [asdict(p) for p in w[key]]
        for p in g["weak_params"]:
            assert p.rotate_deg == 0.0 and p.zoom_out is None \
                and p.zoom_in_factor == 1.0 and not p.tflip
        strong_zoom |= any(p.zoom_out is not None or p.zoom_in_factor > 1
                           for p in g["strong_applied"])
    assert strong_zoom


def _state_dict_of(det, tree):
    """The JAX variables `tree` laid out as `det.state_dict()`'s fp32
    tensors, by name (BN's batch counters, which JAX has not, as det's)."""
    out = {k: v.detach().clone() for k, v in det.state_dict().items()}
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(tree[coll]):
            module = det.get_submodule(".".join(path[:-1]))
            name, val = _target(module, path[-1], arr)
            prefix = ".".join(path[:-1])
            out[f"{prefix}.{name}" if prefix else name] = torch.from_numpy(
                np.ascontiguousarray(val, np.float32))
    return out


@pytest.mark.parametrize("method,alpha", [("ema", 0.9), ("ema", 0.999),
                                          ("every-2", 0.999)])
def test_teacher_update_matches_jax(weights, method, alpha):
    """Three updates of a teacher from three students (the model's
    variables, perturbed): every leaf within 1e-7 of the JAX package's
    (relative to its largest)."""
    det = Detector(_cfg(tc, "").model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, weights)
    rng = np.random.default_rng(2)
    students = [jax.tree.map(lambda x: (x * rng.uniform(0.5, 1.5, x.shape)
                                        ).astype(np.float32), weights)
                for _ in range(3)]
    jupd = jon.make_teacher_update(method, alpha)
    tupd = ton.make_teacher_update(method, alpha)
    jt = jax.tree.map(lambda x: jnp.array(x, jnp.float32), weights)
    teacher = {k: v.detach().clone() for k, v in det.state_dict().items()}
    for step, s in enumerate(students):
        jt = jupd(jt, jax.tree.map(jnp.asarray, s), step + 1)
        teacher = tupd(teacher, _state_dict_of(det, s), step + 1)
    want = _state_dict_of(det, jax.tree.map(np.asarray, jt))
    moved = 0
    for k, w in want.items():
        g = teacher[k]
        if not g.is_floating_point():
            continue
        assert g.dtype == torch.float32, k
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-7 * scale, err_msg=k)
        moved += not torch.equal(g, det.state_dict()[k])
    assert moved > len(want) // 2


def _batchers(root, weights):
    jcfg, tcfg = _cfg(jc, root, **SSOD), _cfg(tc, root, **SSOD)
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    jb = jon.OnlineSSODBatcher(None, jdet, jax.tree.map(jnp.asarray, weights),
                               jcfg, B)
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, weights)
    return jcfg, tcfg, jb, ton.OnlineSSODBatcher(None, det, tcfg, B)


def test_ssod_merge_matches_jax(root, weights):
    """The same paired batches and teacher detections (seeded, scores in
    (0, 1)) through both batchers' `_merge`: the strong batch's labels,
    GT where it stands and mapped pseudo boxes elsewhere, exactly."""
    jcfg, tcfg, jb, tb = _batchers(root, weights)
    rng = np.random.default_rng(3)
    merged = 0
    for pair in _pairs(tl, tcfg, 3, seed=1):
        n = 16
        xy = rng.uniform(0, 80, (B * L, n, 2))
        wh = rng.uniform(4, 40, (B * L, n, 2))
        dets = np.concatenate(
            [xy, xy + wh, rng.uniform(0, 1, (B * L, n, 2)),
             rng.integers(0, 2, (B * L, n, 1))], -1).astype(np.float32)
        valid = rng.uniform(0, 1, (B * L, n)) < 0.6
        lens = rng.integers(0, 2, B)
        jb.lens[:], tb.lens[:] = lens, lens
        got = tb._merge(pair, dets, valid)
        want = jb._merge(pair, dets, valid)
        for grow, wrow, srow in zip(got["labels"], want["labels"],
                                    pair["strong"]["labels"]):
            for g, w, s in zip(grow, wrow, srow):
                assert (g is None) == (w is None)
                if g is not None:
                    assert np.array_equal(g.arr, w.arr)
                    assert g.size_hw == w.size_hw
                    merged += g is not s
        for k in ("ev", "is_first", "is_padded"):
            assert np.array_equal(got[k], want[k])
    assert merged > 0


def test_burn_in_counter_seeds_from_restored_step(root, weights):
    _, tcfg, _, _ = _batchers(root, weights)
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    b = ton.OnlineSSODBatcher(None, det, tcfg, B, start_step=7)
    assert b.batches_out == 7
    assert all(t.dtype == torch.float32 for t in b.teacher.values()
               if t.is_floating_point())


def _pseudo_split(root, tcfg, out):
    """A pseudo dataset written by the port's recorder from seeded labels
    with h-flip and t-flip views: pseudo boxes of low and high
    confidence, tracker-ignored and inpainted boxes, and GT frames."""
    rng = np.random.default_rng(9)
    for seq_dir in list_sequence_dirs(root, "train"):
        n = EventSequence(seq_dir, tcfg.dataset).num_ev_repr
        labels = [l.scale(0.3) for l in _frame_labels(rng, n)]
        _record(tpl, seq_dir, labels, tcfg).save(out, tcfg.dataset)
    return out


def test_soft_student_step_matches_jax(root, weights, tmp_path):
    """One train step of the soft student (`experiment_preset(...,
    soft=True)`: pseudo boxes under the per-class thresholds become
    ignore regions) on a batch of a written pseudo split, harvested with
    the whole window as its budget: the loss and its components within
    1e-4; the whole gradient within 1e-5 of `jax.grad`'s in l2 norm
    (|g - g_jax| <= 1e-5 |g_jax| over all parameters together), and each
    tensor elementwise within 1e-4 of its largest
    (`test_torch_port_train_step.py`'s bound). A LayerScale gradient, a
    sum over every token, alone differs by about 1e-5 of its norm: fp32
    reduction order."""
    tcfg = _cfg(tc, root, soft=True)
    pse = _pseudo_split(root, tcfg, str(tmp_path / "pse"))
    jcfg = _cfg(jc, root, soft=True)
    jdst = replace(jcfg.dataset, path=pse, ratio=-1.0, train_ratio=-1.0)
    seqs = jl.open_split_sequences(jdst, "train")
    # the first batch of the stream holding ignore regions and pseudo
    # boxes under the soft head's thresholds
    for batch in jl.StreamTrainLoader(seqs, jdst, B, 0):
        hb = jl.harvest_frames(batch, L, jcfg.model.head.max_gt,
                               jcfg.model.backbone.in_res_hw,
                               ignore_label=jcfg.model.head.ignore_label,
                               fold_hw=stem_fold_hw(tcfg.model))
        lab = hb["labels"]
        if (lab[..., 0] == 1024).any() and \
                ((lab[..., 5] > 0) & (lab[..., 5] < 0.35)).any():
            break
    assert hb["frame_mask"].sum() > 2 * B and not hb["dropped_frames"]
    dev = {k: hb[k] for k in ("ev", "is_first", "frame_t", "frame_mask",
                              "labels")}
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    tx = _capture_grads()
    init = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0)))
    jst, jm = jax.jit(jstep.make_train_step(jdet, tx))(
        _j_state(jdet, init, tx), {k: jnp.asarray(x) for k, x in dev.items()})
    jst_grads = jax.tree.map(np.asarray, jst.opt_state)
    det = Detector(tcfg.model, dtype=torch.float32, device="cpu",
                   trainable=True)
    load_jax_variables(det, init)
    opt, _ = make_optimizer(replace(tcfg.training, gradient_clip_val=0.0),
                            det.parameters())
    _, tm = make_train_step(det, opt)(
        TrainState(states=det.init_states(B), step=0), dev)
    assert float(jm["num_fg"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    n, err2, norm2 = 0, 0.0, 0.0
    for path, want, got in _each_tensor(det, jst_grads, "grad",
                                        lambda t: t.grad.numpy()):
        err2 += float(np.sum((got.astype(np.float64) - want) ** 2))
        norm2 += float(np.sum(want.astype(np.float64) ** 2))
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=path)
        n += 1
    assert n == len(list(det.parameters()))
    assert np.sqrt(err2) <= 1e-5 * np.sqrt(norm2)


def test_online_ssod_fit(root, weights, tmp_path, monkeypatch):
    """`Trainer.fit` with `ssod_online` on the CPU: three steps, the
    first GT only (burn-in 1), pseudo boxes merged into the next two;
    after every step the teacher is the EMA of itself and the student;
    a resumed fit's burn-in counter starts at the restored step."""
    cfg = _cfg(tc, root, **SSOD)
    cfg = replace(cfg, save_dir=str(tmp_path))
    splits = render_array_dataset(cfg.dataset, **SPLIT)
    checks = []
    orig = ton.OnlineSSODBatcher.update_teacher

    def checked(self, student, step):
        before = {k: v.clone() for k, v in self.teacher.items()}
        s = {k: v.detach().float().clone()
             for k, v in student.state_dict().items()}
        orig(self, student, step)
        a = np.float32(min(1 - 1 / (step + 1), cfg.training.ssod_online.alpha))
        for k, t in self.teacher.items():
            if t.is_floating_point():
                want = before[k] * float(a) + s[k] * float(np.float32(1) - a)
                torch.testing.assert_close(t, want, rtol=0, atol=1e-6)
        inf = self.teacher_det.state_dict()
        assert all(torch.equal(inf[k], self.teacher[k]) for k in inf
                   if inf[k].is_floating_point())
        checks.append(step)

    monkeypatch.setattr(ton.OnlineSSODBatcher, "update_teacher", checked)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu")
    state = trainer.init_state(B)
    load_jax_variables(trainer.det, weights)
    timings = {}
    state = trainer.fit(max_steps=3, state=state, log_every=1,
                        sequences=splits["train"], timings=timings)
    assert state.step == 3 and checks == [1, 2, 3]
    assert len(timings["teacher_update_ms"]) == 3
    merged = trainer.ssod_batcher.merged
    assert merged[0] == 0 and all(merged[1:3]), merged
    trainer.close()

    fresh = Trainer(cfg, dtype=torch.float32, device="cpu")
    st, path = fresh.restore_latest(fresh.init_state(B))
    assert path is not None and st.step == 3
    st = fresh.fit(max_steps=4, state=st, log_every=1,
                   sequences=splits["train"])
    assert st.step == 4 and checks == [1, 2, 3, 4]
    assert fresh.ssod_batcher.batches_out >= 4
    assert fresh.ssod_batcher.merged[0] > 0          # no second burn-in
    fresh.close()
