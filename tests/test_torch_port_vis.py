"""The port's visualization CLI (`leod_tpu_torch.cli.vis`, the port of
`cli/vis.py`) on the CPU.

A tiny split (one test sequence of 16 reprs at 64 x 96, written by the
JAX generator) and an RVT-T model at that resolution (the CLI's
`build_config` wrapped to re-derive the preset at 64 x 96, as the chip
script wraps `cli.train.build_config`) whose weights are a seeded JAX
tree with the prediction layers scaled (`_randomize`), carried into the
port by `load_jax_variables` and saved as the port's checkpoint. The
CLI with `--reverse` must write the normal and the side-by-side video
with every frame, the latter 2w + 4 wide; and the frames it draws before
encoding must be, pixel for pixel, the JAX CLI's drawing
(`leod_tpu.utils.viz`) of the JAX eval step's detections on the same
windows, forwards and time-reversed.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu.config import derive as j_derive
from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.config import stem_width_fold as j_stem_width_fold
from leod_tpu.data.loader import collate as j_collate
from leod_tpu.data.loader import harvest_frames as j_harvest
from leod_tpu.data.loader import open_split_sequences as j_open_split
from leod_tpu.data.sequence import WindowedSequence as JWindowed
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.ops.nms import postprocess as j_postprocess
from leod_tpu.train.step import make_eval_step as j_make_eval_step
from leod_tpu.utils import viz as jviz

from leod_tpu_torch.cli import vis as tvis
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.data.loader import open_split_sequences
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.train.step import make_eval_step

from test_torch_port_serve import _randomize

HW = (64, 96)
REPRS = 16
L = 4
CONF, SHOW_CONF = 0.3, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _at_hw(cfg):
    """The preset re-derived for 64 x 96 frames (in_res 64 x 96,
    partition 2 x 3)."""
    dst = dataclasses.replace(cfg.dataset, resolution_hw=HW)
    return dataclasses.replace(cfg, dataset=dst)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vis_data"))
    j_generate_dataset(root, num_train=0, num_val=0, num_test=1,
                       num_reprs=REPRS, label_every=4, first_label_repr=3,
                       hw=HW)
    jcfg = j_derive(_at_hw(j_experiment_preset("gen1", "tiny")))
    jcfg = dataclasses.replace(jcfg, dataset=dataclasses.replace(
        jcfg.dataset, path=root, sequence_length=L))
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    variables = _randomize(jax.tree.map(
        np.asarray, jdet.init(jax.random.PRNGKey(0), batch_size=1)),
        np.random.default_rng(0))
    argv = ["--path", root, "--size", "tiny", "--seq-len", str(L),
            "--num-seqs", "1", "--reverse", "--cpu", "--fp32",
            "--conf", str(CONF), "--show-conf", str(SHOW_CONF)]
    return {"root": root, "jcfg": jcfg, "jdet": jdet,
            "variables": variables, "argv": argv}


def _port_detector(cfg, variables):
    det = Detector(cfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(det, variables)
    return det


@pytest.fixture(scope="module")
def cli_run(setup, tmp_path_factory):
    """The CLI as a user runs it, on the port's checkpoint of the
    seeded weights."""
    work = tmp_path_factory.mktemp("vis_cli")
    build = tvis.build_config

    def at_hw(args, path):
        return tvis.derive(_at_hw(build(args, path)))
    mp = pytest.MonkeyPatch()
    mp.setattr(tvis, "build_config", at_hw)
    try:
        cfg = at_hw(tvis.build_parser().parse_args(setup["argv"]),
                    setup["root"])
        ckpt = str(work / "ckpt_vis.pt")
        torch.save({"model": _port_detector(
            cfg, setup["variables"]).state_dict()}, ckpt)
        out = str(work / "out")
        written = tvis.main(setup["argv"] + ["--ckpt", ckpt, "--out", out])
    finally:
        mp.undo()
    return {"cfg": cfg, "out": out, "written": written}


def _jax_render(setup, time_flip):
    """The JAX CLI's `render_seq` (cli/vis.py:95-136) on the JAX eval
    step: the drawn frames and each frame's detections."""
    jcfg = setup["jcfg"]
    seq = j_open_split(jcfg.dataset, "test")[0]
    step = jax.jit(j_make_eval_step(setup["jdet"]))
    win = JWindowed(seq, L, start_from_zero=True, time_flip=time_flip)
    states = setup["jdet"].init_states(1)
    frames, kept = [], []
    for i in range(len(win)):
        batch = j_collate([win[i]])
        hb = j_harvest(batch, L, jcfg.model.head.max_gt,
                       jcfg.model.backbone.in_res_hw,
                       fold_w=j_stem_width_fold(jcfg.model))
        hb["frame_t"] = np.arange(L, dtype=np.int32)[None]
        hb["frame_mask"] = np.ones((1, L), bool)
        dev = {k: hb[k] for k in ("ev", "is_first", "frame_t", "frame_mask",
                                  "labels")}
        states, preds = step(setup["variables"], states, dev)
        pp = jcfg.model.postprocess
        dets, valid = j_postprocess(
            preds, num_classes=jcfg.model.head.num_classes,
            conf_threshold=SHOW_CONF, nms_threshold=pp.nms_threshold,
            pre_topk=pp.pre_nms_topk, max_dets=pp.max_dets)
        dets, valid = np.asarray(dets), np.asarray(valid)
        for t in range(L):
            if batch["is_padded"][0, t]:
                continue
            img = jviz.render_event_frame(batch["ev"][t, 0])
            d = dets[t][valid[t]]
            score = d[:, 4] * d[:, 5]
            strong, weak = d[score >= CONF], d[score < CONF]
            jviz.draw_boxes(img, weak, (0, 0, 255))
            jviz.draw_boxes(img, strong, (0, 200, 0),
                            [f"{int(b[6])}:{b[4] * b[5]:.2f}" for b in strong])
            gt = batch["labels"][t][0]
            if gt is not None:
                jviz.draw_boxes(img, gt.xyxy(), (0, 0, 0))
            frames.append(img)
            kept.append(d)
    seq.close()
    return frames, kept


def test_vis_writes_both_videos(cli_run):
    import cv2
    written = cli_run["written"]
    normal = os.path.join(cli_run["out"], "seq_000.mp4")
    both = os.path.join(cli_run["out"], "seq_000_both.mp4")
    assert sorted(written) == sorted([normal, both])
    for path in (normal, both):
        cap = cv2.VideoCapture(path)
        assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == REPRS == \
            written[path]["frames"]
        assert cap.get(cv2.CAP_PROP_FRAME_HEIGHT) == HW[0]
    wn = cv2.VideoCapture(normal).get(cv2.CAP_PROP_FRAME_WIDTH)
    wb = cv2.VideoCapture(both).get(cv2.CAP_PROP_FRAME_WIDTH)
    assert wn == HW[1] and wb == 2 * wn + tvis.PAD


@pytest.mark.parametrize("time_flip", [False, True])
def test_vis_frames_match_jax_drawing(setup, cli_run, time_flip):
    cfg = cli_run["cfg"]
    det = _port_detector(cfg, setup["variables"])
    dst = dataclasses.replace(cfg.dataset, path=setup["root"])
    seq = open_split_sequences(dst, "test")[0]
    got = tvis.render_sequence(det, dataclasses.replace(cfg, dataset=dst),
                               seq, make_eval_step(det, device="cpu"), CONF,
                               SHOW_CONF, time_flip=time_flip)
    seq.close()
    want_frames, want_dets = _jax_render(setup, time_flip)
    assert len(got["frames"]) == len(want_frames) == REPRS
    n_strong = n_weak = 0
    for g, w in zip(got["dets"], want_dets):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        score = g[:, 4] * g[:, 5]
        n_strong += int((score >= CONF).sum())
        n_weak += int((score < CONF).sum())
    # the frames carry both kinds of boxes, and are the JAX CLI's
    assert n_strong > 0 and n_weak > 0
    for g, w in zip(got["frames"], want_frames):
        np.testing.assert_array_equal(g, w)
    if not time_flip:
        assert [d.shape for d in got["dets"]] == \
            [d.shape for d in cli_run["written"][os.path.join(
                cli_run["out"], "seq_000.mp4")]["dets"]]
