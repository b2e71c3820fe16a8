"""The op library and the artifact that carries it, on the CPU in
float32: the six ops' C++ CPU implementations (`csrc/torch_ops.cpp`)
against the Python plain versions; a port artifact run by `artifact.py`
copied alone into an empty directory (`python -I`, no package, no
`PYTHONPATH`) against the in-package artifact bit for bit and against
the JAX package's artifact within 1e-4; the loader's refusals (another
build already loaded, another torch, a library without the CUDA kernels
for a card, an artifact without a library in a package-free process, a
library other than the one pinned); `artifact.run`'s default device
(the card); a card without nvcc; and the build's file lock (one build
among processes that start together)."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from leod_tpu.serve import artifact_meta as j_artifact_meta
from leod_tpu.serve import export_serve_step as j_export_serve_step
from leod_tpu.serve import load_artifact as j_load_artifact
from leod_tpu.serve import save_artifact as j_save_artifact
from leod_tpu.serve import zero_states_like as j_zero_states_like

from leod_tpu_torch import artifact
from leod_tpu_torch.models.layers import (PartitionAttention, _SplitGateConv,
                                          grid_partition, grid_reverse,
                                          window_partition, window_reverse)
from leod_tpu_torch.ops import _build, maxvit_cuda, nms_cuda
from leod_tpu_torch.ops.nms import nms_mask as nms_mask_python
from leod_tpu_torch.serve import (artifact_meta, export_serve_step,
                                  load_artifact, load_artifact_exported,
                                  save_artifact)

from test_torch_port_serve import _frames, _models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT_PY = os.path.join(REPO, "leod_tpu_torch", "artifact.py")
PLAIN_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
C, PART, K = 32, (2, 3), 16
B = 2
STEPS = (([1, 1], [1, 1]), ([0, 0], [1, 1]), ([1, 0], [0, 1]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine's cores: torch runs on one
    thread in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(kind, seed, skip=False, gated=False, act="gelu"):
    """A PartitionAttention block of width C with every parameter drawn
    from a numpy seed at O(1) scale (LayerScale in [0.2, 0.8])."""
    blk = PartitionAttention(C, PART, kind, skip_first_norm=skip,
                             mlp_gated=gated, mlp_act=act)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith(("ls1", "ls2")):
                v = rng.uniform(0.2, 0.8, p.shape)
            else:
                v = rng.normal(size=p.shape) / (p[0].numel() ** 0.5
                                                 if p.dim() > 1 else 4.0)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return blk.requires_grad_(False)


def _x(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _close(got, want):
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PLAIN_TOL)


# ---------------------------------------------------------------------------
# The C++ CPU implementations against the Python plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_kind,skip", [(False, True), (False, False),
                                            (True, False)])
def test_cpp_block_attention_is_the_plain_version(grid_kind, skip):
    """`leod_tpu_torch::block_attention` on the CPU (the partition, LN1
    unless skipped, attention to the output projection, the inverse
    partition) against `block_attention_plain` on the partitioned
    tokens."""
    blk = _block("grid" if grid_kind else "window", 1, skip=skip)
    x = _x(np.random.default_rng(2), 2, 4, 6, C)
    part, rev = ((grid_partition, grid_reverse) if grid_kind
                 else (window_partition, window_reverse))
    want = rev(maxvit_cuda.block_attention_plain(part(x, *PART), blk),
               *PART, 4, 6)
    _close(maxvit_cuda.block_attention(x, blk, grid_kind), want)


@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu"),
                                       (False, "relu")])
def test_cpp_block_mlp_is_the_plain_version(gated, act):
    blk = _block("window", 3, gated=gated, act=act)
    rng = np.random.default_rng(4)
    x, o = _x(rng, 2, 4, 6, C), _x(rng, 2, 4, 6, C)
    _close(maxvit_cuda.block_mlp(x, o, blk, act, gated),
           maxvit_cuda.block_mlp_plain(x, o, blk))


@pytest.mark.parametrize("gated", [False, True])
def test_cpp_model_axis_ops_are_the_plain_versions(gated):
    """`block_mlp_tp` (x1 and the partial MLP output) and
    `block_residual`, the model axis's two ops."""
    blk = _block("grid", 5, gated=gated)
    rng = np.random.default_rng(6)
    x, a, p = (_x(rng, 2, 4, 6, C) for _ in range(3))
    _close(maxvit_cuda.block_mlp_tp(x, a, blk, gated=gated),
           maxvit_cuda.block_mlp_tp_plain(x, a, blk))
    _close(maxvit_cuda.block_residual(x, p, blk),
           maxvit_cuda.block_residual_plain(x, p, blk))


def test_cpp_lstm_update_is_the_plain_version():
    gates = _SplitGateConv(C)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        gates.weight.copy_(_x(rng, 4 * C, 2 * C, 1, 1) / (2 * C) ** 0.5)
        gates.bias.copy_(_x(rng, 4 * C))
    gates.requires_grad_(False)
    x, h, c = (_x(rng, 2, 4, 6, C) for _ in range(3))
    _close(maxvit_cuda.lstm_update(x, h, c, gates),
           maxvit_cuda.lstm_update_plain(x, h, c, gates))


@pytest.mark.parametrize("with_ids", [False, True])
def test_cpp_nms_mask_is_the_plain_version(with_ids):
    """K = 16 boxes in clusters (so that some suppress others), with and
    without class ids, in a batch of 3 and as one [K, 4] image: the keep
    mask exactly."""
    rng = np.random.default_rng(8)
    ctr = rng.uniform(0, 24, (3, K, 2)) // 12 * 12
    wh = rng.uniform(9, 12, (3, K, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2],
                                            -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(3, K)) < 0.85)
    ids = (torch.from_numpy(rng.integers(0, 2, (3, K)).astype(np.float32))
           if with_ids else None)
    got = nms_cuda.nms_mask(boxes, 0.45, valid, ids)
    want = nms_mask_python(boxes, 0.45, valid, ids)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())     # something suppressed
    one = nms_cuda.nms_mask(boxes[0], 0.45, valid[0],
                            None if ids is None else ids[0])
    assert torch.equal(one, want[0])


# ---------------------------------------------------------------------------
# The artifact without the package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory, _one_torch_thread):
    """RVT-T widths at 64 x 96 (`test_torch_port_serve._models`), both
    packages' serve steps exported from the same JAX variables at
    conf 0, B = 2, and saved; the port's artifact carries the op
    library this process built."""
    jcfg, tcfg, jdet, v, tdet = _models("tiny")
    out = tmp_path_factory.mktemp("artifact")
    path = str(out / "model.pt2")
    ep = export_serve_step(tdet, tcfg, B, conf_threshold=0.0)
    record = save_artifact(ep, path, artifact_meta(tcfg, B, True, 0.0))
    jpath = str(out / "model.stablehlo")
    jexp = j_export_serve_step(jdet, v, jcfg, B, conf_threshold=0.0)
    j_save_artifact(jexp, jpath, j_artifact_meta(jcfg, B, True, 0.0))
    rng = np.random.default_rng(7)
    inputs = {"ev": [], "reset": [], "active": []}
    for reset, active in STEPS:
        inputs["ev"].append(torch.from_numpy(_frames(rng, tcfg, B)))
        inputs["reset"].append(torch.tensor(reset, dtype=torch.bool))
        inputs["active"].append(torch.tensor(active, dtype=torch.bool))
    inp = str(out / "inputs.pt")
    torch.save(inputs, inp)
    return dict(tcfg=tcfg, ep=ep, path=path, record=record, jexp=jexp,
                jpath=jpath, inputs=inputs, inputs_path=inp, out=out)


def _lone(tmp, *args):
    """`python -I artifact.py ...` with `artifact.py` copied alone into
    `tmp`, which is the working directory; no PYTHONPATH."""
    os.makedirs(tmp, exist_ok=True)
    shutil.copy(ARTIFACT_PY, tmp)
    # one intra-op thread, as in this process: the same reduction order
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("PYTHON")}, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-I", "artifact.py", *args, "--device", "cpu",
         "--cache", os.path.join(tmp, "cache")],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)


def test_artifact_runs_without_the_package(exported, tmp_path):
    """Three steps with a reset and an idle row in a process that has
    neither package: the same states, dets and valid as the in-package
    artifact bit for bit, within 1e-4 of the JAX package's artifact
    (valid exact), and no launch counted on the CPU."""
    lone = str(tmp_path / "lone")
    res = _lone(lone, exported["path"], "--inputs",
                exported["inputs_path"], "--out", str(tmp_path / "o.pt"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(str(tmp_path / "o.pt"))
    assert got["modules"] == []
    assert sorted(os.listdir(lone)) == ["artifact.py", "cache"]
    lib = got["op_library"]
    assert lib["build"] == exported["record"]["build"] == _build.build_key()
    assert lib["path"].startswith(os.path.join(lone, "cache"))
    assert all(not any(d.values()) for d in got["launches"])
    parts = [got[k] for k in ("load_ops_s", "load_program_s", "module_s")]
    assert min(parts) >= 0 and abs(sum(parts) - got["load_s"]) < 1e-6

    step_fn, meta = load_artifact(exported["path"], device="cpu")
    assert meta["op_library"] == exported["record"]
    inputs = exported["inputs"]
    st = artifact.zero_states(exported["ep"], "cpu")
    jst = j_zero_states_like(exported["jexp"])
    j_step, _ = j_load_artifact(exported["jpath"])
    for t in range(len(STEPS)):
        ev, reset, active = (inputs[k][t] for k in ("ev", "reset", "active"))
        st, d, v = step_fn(st, ev, reset, active)
        jst, jd, jv = j_step(jst, ev.numpy(), reset.numpy(), active.numpy())
        assert torch.equal(got["valid"][t], v)
        assert torch.equal(got["dets"][t], d)
        for (h, c), (gh, gc), (jh, jc) in zip(st, got["states"][t], jst):
            assert torch.equal(gh, h) and torch.equal(gc, c)
            np.testing.assert_allclose(gh.numpy(), np.asarray(jh), **JAX_TOL)
            np.testing.assert_allclose(gc.numpy(), np.asarray(jc), **JAX_TOL)
        np.testing.assert_array_equal(got["valid"][t].numpy(), np.asarray(jv))
        np.testing.assert_allclose(got["dets"][t].numpy(), np.asarray(jd),
                                   **JAX_TOL)
    assert got["valid"][0].any()


def test_artifact_records_its_library(exported):
    """The artifact carries the library this process loaded, its sha256
    and build (the package's hash of sources, flags, torch and variant),
    variant and torch; the sidecar keeps the same record."""
    data = open(_build.load(), "rb").read()
    rec = exported["record"]
    assert rec == {**artifact.library_info(data), "bytes": len(data),
                   "sha256": hashlib.sha256(data).hexdigest()}
    assert rec["variant"] == _build.variant() == "cpu"
    assert rec["torch"] == torch.__version__
    with open(exported["path"] + ".json") as f:
        assert json.load(f)["op_library"] == rec


def test_loader_refuses_another_build(exported, tmp_path):
    """An artifact whose library is another build (its build string
    changed in the bytes) does not load where this build is loaded; the
    error names both builds."""
    data = open(_build.load(), "rb").read()
    key = _build.build_key()
    other = "f" * len(key) if key != "f" * len(key) else "e" * len(key)
    tag = b'LEOD_OPS_INFO{"build": "'
    assert data.count(tag + key.encode()) == 1
    lib = str(tmp_path / "libother.so")
    with open(lib, "wb") as f:
        f.write(data.replace(tag + key.encode(), tag + other.encode()))
    path = str(tmp_path / "other.pt2")
    artifact.save_artifact(exported["ep"], path, {}, library=lib)
    with pytest.raises(RuntimeError, match=f"build {key}.*build {other}"):
        load_artifact_exported(path)


def test_loader_refuses_another_torch(exported, monkeypatch):
    monkeypatch.setattr(torch, "__version__", "0.0.1+other")
    with pytest.raises(RuntimeError, match="torch 0.0.1\\+other"):
        load_artifact_exported(exported["path"])


def test_loader_refuses_the_card_without_its_kernels(exported):
    """A program for the card cannot run on ops without the CUDA kernels
    (this build is "cpu"): it raises before moving anything."""
    ep, _ = load_artifact_exported(exported["path"])
    ep.platforms = ("cpu", "cuda")
    with pytest.raises(RuntimeError, match="without the CUDA kernels"):
        artifact.program_module(ep, "cuda")


def test_artifact_without_library_needs_the_package(exported, tmp_path):
    """An artifact saved as before artifacts carried their library loads
    where the package is imported, and refuses in a package-free
    process."""
    old = str(tmp_path / "old.pt2")
    torch.export.save(exported["ep"], old,
                      extra_files={"platforms": json.dumps(["cpu"])})
    step_fn, _ = load_artifact(old, device="cpu")
    inputs = exported["inputs"]
    st = artifact.zero_states(exported["ep"], "cpu")
    _, d, _ = step_fn(st, inputs["ev"][0], inputs["reset"][0],
                      inputs["active"][0])
    assert d.shape[0] == B
    res = _lone(str(tmp_path / "lone"), old, "--inputs",
                exported["inputs_path"], "--out", str(tmp_path / "o.pt"))
    assert res.returncode != 0
    assert "carries no op library" in res.stderr
    assert not os.path.exists(str(tmp_path / "o.pt"))


_LOCK_CHILD = """
import sys, time
from leod_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]

def fake(out, var):
    with open(sys.argv[2], "a") as f:
        f.write("built\\n")
    time.sleep(3.0)
    open(out, "w").close()

_build._compile = fake
print(_build.build())
"""


def test_build_lock_lets_one_process_build(tmp_path):
    """Three processes that need the library at once: one compiles, the
    others wait on the lock and take its library (the compiler is a
    stand-in that takes three seconds)."""
    log = str(tmp_path / "builds.log")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _LOCK_CHILD,
                               str(tmp_path / "build"), log], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1 and os.path.exists(paths.pop())
    with open(log) as f:
        assert f.read() == "built\n"


def test_loader_refuses_a_library_not_pinned(exported, tmp_path):
    """A caller that pins the library's sha256 loads the artifact whose
    library has it, and is refused any other before anything is loaded:
    in this process and in a package-free one (whose cache stays
    empty)."""
    sha = exported["record"]["sha256"]
    ep, _ = load_artifact_exported(exported["path"], sha256=sha)
    assert ep.platforms == ("cpu",)
    other = "0" * len(sha)
    with pytest.raises(RuntimeError, match=f"{sha}, not the pinned {other}"):
        load_artifact_exported(exported["path"], sha256=other)
    lone = str(tmp_path / "lone")
    res = _lone(lone, exported["path"], "--inputs", exported["inputs_path"],
                "--out", str(tmp_path / "o.pt"), "--sha256", other)
    assert res.returncode != 0
    assert f"not the pinned {other}" in res.stderr
    cache = os.path.join(lone, "cache")
    assert not os.path.exists(cache) or not os.listdir(cache)
    assert not os.path.exists(str(tmp_path / "o.pt"))


def test_run_defaults_to_the_card(exported):
    """`artifact.run` without a device runs on the card: a CPU artifact
    is refused there rather than run on the CPU unasked."""
    with pytest.raises(ValueError, match="not cuda"):
        artifact.run(exported["path"], exported["inputs"])


def test_card_without_nvcc_raises(monkeypatch, exported, tmp_path):
    """A CUDA torch on a machine with a card and no nvcc builds no
    CPU-only library in its place (it raises, naming nvcc); with no card
    the library is the CPU build. An artifact for the card saved with a
    library that lacks the CUDA kernels warns that it will not run
    there."""
    def no_nvcc():
        raise RuntimeError("nvcc not found: stand-in")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.variant()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _build.variant() == _build.CPU_VARIANT
    monkeypatch.undo()
    ep, _ = load_artifact_exported(exported["path"])
    ep.platforms = ("cpu", "cuda")
    with pytest.warns(UserWarning, match="without the CUDA kernels"):
        artifact.save_artifact(ep, str(tmp_path / "card.pt2"), {})
