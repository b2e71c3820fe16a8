"""The port's CLIs against the JAX package's on the CPU: the
`ExperimentConfig` each CLI builds from the flags of every invocation in
`tools/selftrain_cycle.sh` (and --ssod-online, --tflip, --gradflow),
reference PyTorch checkpoints through the port's converter, and the
self-training cycle driver end to end at RVT-T widths, its pseudo
dataset scored by `cli/val_dst.py` of both packages."""
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from leod_tpu import convert as jconvert
from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.data.synthetic import generate_dataset as j_generate_dataset
from leod_tpu.models.detector import Detector as JDetector

from leod_tpu_torch import convert as tconvert
from leod_tpu_torch.cli import predict as tpredict
from leod_tpu_torch.cli import selftrain_cycle as tcycle
from leod_tpu_torch.cli import train as ttrain
from leod_tpu_torch.cli import val as tval
from leod_tpu_torch.config import experiment_preset
from leod_tpu_torch.data.synthetic import render_dataset_frames
from leod_tpu_torch.models.detector import Detector

from chip_smoke import reference_key, reference_state_dict
from test_torch_port_serve import _tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine's cores: torch runs on one
    thread in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_cli_{name}", os.path.join(REPO, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Argument mapping
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


def _recorder(store, key):
    """A stand-in for Trainer / run_streaming_eval / PseudoLabelRunner:
    records the config it is given and stops the CLI."""
    def stub(*args, **kwargs):
        cfgs = [a for a in args if type(a).__name__ in
                ("ExperimentConfig", "PseudoLabelConfig")]
        store[key] = cfgs
        raise _Captured
    return stub


W = "/nonexistent/cycle"
SIZE = ["--dataset", "gen1", "--size", "base"]
SHAPE = ["--batch-size", "8", "--seq-len", "21"]
TRAIN_TAIL = ["--ckpt-every-min", "600", "--auto-resume", "--save-dir",
              f"{W}/runs", "--val-every", "0"]
TEACHER = SIZE + ["--path", f"{W}/data", "--ratio", "0.25", "--steps",
                  "300"] + SHAPE + TRAIN_TAIL + ["--exp-name", "teacher"]
STUDENT = SIZE + ["--path", f"{W}/pseudo", "--soft", "--weight",
                  f"{W}/runs/teacher/ckpt_last", "--steps", "300"] + SHAPE + [
    "--lr", "5e-4"] + TRAIN_TAIL + ["--exp-name", "student"]
EVAL = SIZE + ["--path", f"{W}/data", "--split", "val", "--seq-len", "21",
               "--ckpt", f"{W}/runs/teacher/ckpt_last"]
PREDICT = SIZE + ["--path", f"{W}/data", "--ratio", "0.25", "--ckpt",
                  f"{W}/runs/teacher/ckpt_last", "--save-dir", f"{W}/pseudo",
                  "--seq-len", "21", "--batch-size", "3", "--tta-hflip",
                  "--obj-thresh", "0.3", "0.15", "--cls-thresh", "0.3",
                  "0.15", "--min-track-len", "3", "--conf", "0.05",
                  "--num-shards", "2"]

INVOCATIONS = [
    ("train", TEACHER),
    ("train", STUDENT),
    ("train", TEACHER + ["--ssod-online", "--ssod-alpha", "0.99",
                         "--ssod-burn-in", "5", "--ssod-thresh", "0.5",
                         "0.4", "--ssod-update", "every-10"]),
    ("train", TEACHER + ["--tflip", "--gradflow", "--train-ratio", "0.5",
                         "--sampling", "stream", "--warmup-pct", "0.1",
                         "--max-det-frames", "7", "--fp32", "--seed", "3"]),
    ("train", ["--dataset", "gen4", "--size", "small", "--soft",
               "--path", "/x", "--lr", "1e-3"]),
    ("val", EVAL),
    ("val", EVAL + ["--tta", "--conf", "0.01", "--eval-ratio", "0.5",
                    "--batch-size", "4"]),
    ("predict", PREDICT + ["--shard-index", "0"]),
    ("predict", PREDICT + ["--shard-index", "1"]),
    ("predict", ["--dataset", "gen4", "--size", "tiny", "--path", "/x",
                 "--ckpt", "/c", "--save-dir", "/y", "--tta-tflip", "--no-inpaint",
                 "--track-method", "forward", "--skip-first-t", "2",
                 "--no-use-gt", "--train-ratio", "0.5", "--obj-thresh",
                 "0.5", "0.2", "--cls-thresh", "0.4", "0.1"]),
]


def _jax_configs(monkeypatch, cli, argv):
    import leod_tpu.eval.tta as jtta
    import leod_tpu.selftrain.runner as jrunner
    import leod_tpu.train.trainer as jtrainer
    got = {}
    monkeypatch.setenv("LEOD_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(jtrainer, "Trainer", _recorder(got, "cfg"))
    monkeypatch.setattr(jtrainer, "run_streaming_eval", _recorder(got, "cfg"))
    monkeypatch.setattr(jtta, "run_tta_eval", _recorder(got, "cfg"))
    monkeypatch.setattr(jrunner, "PseudoLabelRunner", _recorder(got, "cfg"))
    monkeypatch.setattr(jtrainer, "load_variables", lambda path: {})
    monkeypatch.setattr(sys, "argv", [cli] + argv)
    with pytest.raises(_Captured):
        _jax_cli(cli).main()
    return got["cfg"]


def _port_configs(monkeypatch, cli, argv):
    mod = {"train": ttrain, "val": tval, "predict": tpredict}[cli]
    got = {}
    for name in ("Trainer", "run_streaming_eval", "run_tta_eval",
                 "PseudoLabelRunner"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, _recorder(got, "cfg"))
    if hasattr(mod, "load_detector"):
        monkeypatch.setattr(mod, "load_detector", lambda *a, **k: None)
    with pytest.raises(_Captured):
        mod.main(argv)
    return got["cfg"]


@pytest.mark.parametrize("cli,argv", INVOCATIONS,
                         ids=[f"{c}{i}" for i, (c, _) in
                              enumerate(INVOCATIONS)])
def test_cli_builds_the_jax_config(monkeypatch, cli, argv):
    """The config (and the pseudo-label config) each port CLI hands to
    its Trainer / eval / runner equals the JAX CLI's, field by field."""
    want = _jax_configs(monkeypatch, cli, argv)
    got = _port_configs(monkeypatch, cli, argv)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_unported_flags_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A.5"):
        ttrain.main(["--mesh", "4x2", "--cpu"])
    os.makedirs(tmp_path / "ckpt_last")                 # an orbax directory
    with pytest.raises(ValueError, match="orbax"):
        tval.main(["--size", "tiny", "--cpu", "--path", str(tmp_path),
                   "--ckpt", str(tmp_path / "ckpt_last")])


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints
# ---------------------------------------------------------------------------

def _variant(preset, kind):
    cfg = _tiny(preset)
    if kind == "plain":
        return cfg
    m = cfg.model
    return replace(cfg, model=replace(
        m, backbone=replace(m.backbone, mlp_gated=True, lstm_dws_conv=True,
                            enable_masking=True),
        fpn=replace(m.fpn, depthwise=True),
        head=replace(m.head, depthwise=True)))


def _to_reference(variables, gated):
    """A JAX `Detector.init` tree as a reference state dict: OIHW convs,
    [out, in] linears, BN weight/bias/running_mean/running_var, under the
    keys `chip_smoke.reference_key` gives (phase 8 writes its reference
    checkpoint with it)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, arr in tconvert._leaves(variables[coll]):
            if path[-1] == "kernel":
                arr = (arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1))
            sd[reference_key(path, gated)] = np.ascontiguousarray(arr)
    return sd


@pytest.fixture(scope="module", params=["plain", "variants"])
def reference(request):
    jcfg = _variant(j_experiment_preset, request.param)
    v = JDetector(jcfg.model, dtype=jax.numpy.float32).init(
        jax.random.PRNGKey(5), batch_size=1)
    v = jax.tree.map(np.asarray, dict(v))
    return request.param, v, _to_reference(v, request.param != "plain")


def _same_tree(a, b):
    fa, fb = dict(tconvert._leaves(a)), dict(tconvert._leaves(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_reference_layout_round_trips_through_jax_converter(reference):
    """The test's inverse of the documented mapping is right: the JAX
    package's converter gives the tree back, with and without the
    Lightning `mdl.` prefix."""
    _, v, sd = reference
    _same_tree(jconvert.convert_torch_state_dict(sd), v)
    _same_tree(jconvert.convert_torch_state_dict(
        {"mdl." + k: a for k, a in sd.items()}), v)


@pytest.mark.parametrize("layout", ["raw", "lightning"])
def test_reference_checkpoint_fills_the_port_detector(reference, layout,
                                                      tmp_path):
    """A reference .ckpt through the port's `load_torch_checkpoint` gives
    the JAX tree, and `load_reference_checkpoint` fills a `Detector`
    equal to `load_jax_variables` of that tree."""
    kind, v, sd = reference
    tsd = {k: torch.tensor(a) for k, a in sd.items()}
    obj = tsd if layout == "raw" else {
        "state_dict": {"mdl." + k: t for k, t in tsd.items()}, "epoch": 3}
    path = str(tmp_path / "ref.ckpt")
    torch.save(obj, path)
    _same_tree(tconvert.load_torch_checkpoint(path), v)
    cfg = _variant(experiment_preset, kind)
    got = Detector(cfg.model, dtype=torch.float32, device="cpu", seed=1,
                   trainable=True)
    tconvert.load_reference_checkpoint(got, path)
    want = Detector(cfg.model, dtype=torch.float32, device="cpu", seed=2,
                    trainable=True)
    tconvert.load_jax_variables(want, v)
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in gs:
        assert torch.equal(gs[k], ws[k]), k


def test_reference_state_dict_of_a_port_detector(reference):
    """`chip_smoke.reference_state_dict` (phase 8's checkpoint) of a port
    detector holding the JAX tree is the reference state dict of that
    tree."""
    kind, v, sd = reference
    det = Detector(_variant(experiment_preset, kind).model,
                   dtype=torch.float32, device="cpu", trainable=True)
    tconvert.load_jax_variables(det, v)
    got = reference_state_dict(det)
    assert sorted(got) == sorted(sd)
    for k, t in got.items():
        assert np.array_equal(t.numpy(), sd[k]), k


def test_reference_checkpoint_leftovers_and_mismatch_raise(reference,
                                                           tmp_path):
    kind, v, sd = reference
    extra = dict(sd, **{"backbone.stages.0.unknown.weight": np.zeros(3)})
    with pytest.raises(ValueError, match="unconsumed"):
        tconvert.convert_torch_state_dict(extra)
    _same_tree(tconvert.convert_torch_state_dict(extra, strict=False), v)
    wider = _variant(experiment_preset, kind)
    wider = replace(wider, model=replace(wider.model, backbone=replace(
        wider.model.backbone, embed_dim=48, dim_head=24)))
    det = Detector(wider.model, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="does not match the model"):
        tconvert.check_compatible(tconvert.convert_torch_state_dict(sd), det)


# ---------------------------------------------------------------------------
# The cycle end to end
# ---------------------------------------------------------------------------

CYCLE = dict(num_train=6, num_reprs=16, seq_len=4, batch=2)


def with_panels_and_gradflow(build_config, viz_every: int):
    """`cli.train.build_config` that also sets a panel every `viz_every`
    steps and gradflow on, which no flag of the CLIs does."""
    def build(args, path):
        cfg = build_config(args, path)
        return replace(cfg, training=replace(
            cfg.training, viz_every_steps=viz_every, gradflow=True))
    return build


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cycle") / "work")
    argv = [work, "--size", "tiny", "--cpu", "--fp32",
            "--steps-teacher", "2", "--steps-student", "2",
            "--seq-len", str(CYCLE["seq_len"]),
            "--num-reprs", str(CYCLE["num_reprs"]),
            "--batch", str(CYCLE["batch"])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "build_config",
                   with_panels_and_gradflow(ttrain.build_config, 2))
        out = tcycle.main(argv)
    return work, argv, out


def test_cycle_writes_every_stage(cycle):
    work, argv, out = cycle
    assert sorted(out["seconds"]) == [f"{n}. {s}" for n, s in
                                      enumerate(tcycle.STAGES)]
    for n in range(7):
        assert os.path.exists(os.path.join(work, f".done_{n}"))
    for run in ("teacher", "student"):
        rd = os.path.join(work, "runs", run)
        assert os.path.exists(os.path.join(rd, "ckpt_last.pt"))
        assert os.listdir(os.path.join(rd, "viz")) == ["step00000002.png"]
        with open(os.path.join(rd, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [1]           # log_every 50
        assert any(k.startswith("gradflow/backbone.stage1.") for k in recs[0])
        assert torch.load(os.path.join(rd, "ckpt_last.pt"),
                          weights_only=True)["step"] == 2
    for name in ("teacher_eval", "student_eval"):
        assert "AP" in out[name]
    assert len(os.listdir(os.path.join(work, "pseudo", "train"))) == \
        CYCLE["num_train"]
    assert os.path.islink(os.path.join(work, "pseudo", "val"))
    # a resumed cycle skips every stage and reads the same results
    again = tcycle.main(argv + ["--resume"])
    assert again == out


def test_cycle_pseudo_score_equals_jax_val_dst(cycle, tmp_path,
                                               monkeypatch):
    """The same pseudo dir scored by `cli/val_dst.py` (which reads h5
    files: the JAX generator writes the split, the pseudo dir links its
    h5) prints the JSON the port's cycle wrote, exactly."""
    work, _, out = cycle
    jdata = j_generate_dataset(
        str(tmp_path / "data"), num_train=CYCLE["num_train"], num_val=4,
        num_test=0, num_reprs=CYCLE["num_reprs"], label_every=2,
        first_label_repr=11)
    jpse = str(tmp_path / "pseudo")
    shutil.copytree(os.path.join(work, "pseudo", "train"),
                    os.path.join(jpse, "train"))
    ev = os.path.join("event_representations_v2",
                      "stacked_histogram_dt=50_nbins=10")
    for seq in sorted(os.listdir(os.path.join(jpse, "train"))):
        a = np.load(os.path.join(work, "data", "train", seq, "labels_v2",
                                 "labels.npz"))
        b = np.load(os.path.join(jdata, "train", seq, "labels_v2",
                                 "labels.npz"))
        assert np.array_equal(a["labels"], b["labels"])
        os.symlink(os.path.join(jdata, "train", seq, ev,
                                "event_representations.h5"),
                   os.path.join(jpse, "train", seq, ev,
                                "event_representations.h5"))
    monkeypatch.setattr(sys, "argv", [
        "val_dst.py", "--dataset", "gen1", "--path", jpse, "--orig-path",
        jdata, "--ratio", "0.25", "--verify"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        _jax_cli("val_dst").main()
    text = buf.getvalue()
    assert text.startswith(f"verified {CYCLE['num_train']} sequences: OK")
    assert json.loads(text[text.index("{"):]) == out["pseudo_score"]
    assert out["pseudo_score"]["ssod/gt_num_car"] > 0


def test_val_cli_tta_on_the_cycle(cycle):
    """`cli.val --tta` on the cycle's val split with the student's
    checkpoint: the COCO metrics of `run_tta_eval`."""
    work, _, _ = cycle
    frames = render_dataset_frames(
        os.path.join(work, "data"), num_train=CYCLE["num_train"],
        num_val=4, num_test=0, num_reprs=CYCLE["num_reprs"], label_every=2,
        first_label_repr=11)
    m = tval.main(["--size", "tiny", "--cpu", "--fp32", "--tta",
                   "--path", os.path.join(work, "data"), "--split", "val",
                   "--seq-len", str(CYCLE["seq_len"]), "--ckpt",
                   os.path.join(work, "runs", "student", "ckpt_last")],
                  frames=frames)
    assert set(m) >= {"AP", "AP_50", "AP_75"}
