"""The port's serving path against the JAX package's on the CPU in
float32: `make_serve_step` over three steps with reset and idle rows at
RVT-T and RVT-S widths, `ServingEngine`, the weight bridge at RVT-B and
RVT-S width, and the port's independence from JAX and from the card."""
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leod_tpu.config import experiment_preset as j_experiment_preset
from leod_tpu.models.backbone import reset_states as j_reset_states
from leod_tpu.models.detector import Detector as JDetector
from leod_tpu.serve import make_serve_step as j_make_serve_step

from leod_tpu_torch.config import experiment_preset
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.backbone import reset_states
from leod_tpu_torch.models.detector import Detector
from leod_tpu_torch.serve import (ServingEngine, make_serve_step,
                                  serve_input_shape)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
B = 3


def _tiny(preset, size="tiny"):
    """RVT-tiny widths (embed 32, FPN depth 0.33), or with size="small"
    RVT-S's (embed 48, heads of 24), at a 64 x 96 input with a (2, 3)
    partition."""
    cfg = preset("gen1", size)
    bb = replace(cfg.model.backbone, in_res_hw=(64, 96),
                 partition_size=(2, 3))
    return replace(cfg, model=replace(cfg.model, backbone=bb))


def _randomize(tree, rng):
    """numpy copy of the JAX variables with O(1) LayerScale, non-trivial
    BN statistics, and prediction layers scaled up (kernels x30, spread
    biases) so that the scores spread over (0, 1) instead of sitting at
    their bias, and every part of the model moves the result."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("ls1", "ls2"):
            out[k] = rng.uniform(0.2, 0.8, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = rng.normal(0.0, 0.02, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.8, 1.25, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    for k, v in out.items():
        if k.startswith(("cls_pred", "obj_pred")):
            v["kernel"] = v["kernel"] * 30.0
            v["bias"] = rng.normal(0.0, 1.0, v["bias"].shape).astype(
                np.float32)
    return out


def _models(size):
    jcfg = _tiny(j_experiment_preset, size)
    tcfg = _tiny(experiment_preset, size)
    jdet = JDetector(jcfg.model, dtype=jnp.float32)
    v = _randomize(jax.tree.map(np.asarray,
                                jdet.init(jax.random.PRNGKey(0))),
                   np.random.default_rng(0))
    tdet = Detector(tcfg.model, dtype=torch.float32, device="cpu")
    load_jax_variables(tdet, v)
    return jcfg, tcfg, jdet, v, tdet


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


@pytest.fixture(scope="module")
def small():
    return _models("small")


def _frames(rng, cfg, n):
    shape = serve_input_shape(cfg, n)
    return np.minimum(rng.poisson(1.0, shape), 255).astype(np.uint8)


def _scores(preds):
    return preds[..., 4] * preds[..., 5:].max(-1)


def _serve_step_matches_jax(models):
    """Three steps with resets and idle rows: states and decoded
    predictions at 1e-4, then dets and valid. The dets are compared only
    after the test has checked that no two candidate scores lie closer
    than the two packages' score difference, so that top-k and NMS must
    take the same boxes in the same order."""
    jcfg, tcfg, jdet, v, tdet = models
    jstep = jax.jit(j_make_serve_step(jdet, v, conf_threshold=0.0))
    jdecode = jax.jit(lambda st, ev: jdet.forward_detect(
        v, jdet.forward_backbone(v, ev, st)[0])[0])
    tstep = make_serve_step(tdet, conf_threshold=0.0, device="cpu")
    rng = np.random.default_rng(9)
    jst, tst = jdet.init_states(B), tdet.init_states(B)
    flags = [([1, 1, 1], [1, 1, 1]), ([0, 1, 0], [1, 1, 0]),
             ([0, 0, 1], [1, 0, 1])]
    for reset, active in flags:
        ev = _frames(rng, tcfg, B)
        reset, active = np.asarray(reset, bool), np.asarray(active, bool)
        want_pred = np.asarray(jdecode(j_reset_states(jst, reset), ev))
        jst, jd, jv = jstep(jst, ev, reset, active)
        t_reset, t_active = torch.from_numpy(reset), torch.from_numpy(active)
        got_pred, _ = tdet.forward_detect(tdet.forward_backbone(
            torch.from_numpy(ev), reset_states(tst, t_reset))[0])
        tst, td, tv = tstep(tst, torch.from_numpy(ev), t_reset, t_active)

        for (th, tc), (jh, jc) in zip(tst, jst):
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(got_pred.numpy(), want_pred, **TOL)
        s = np.sort(_scores(want_pred), axis=-1)
        diff = np.abs(_scores(got_pred.numpy()) - _scores(want_pred)).max()
        assert np.diff(s, axis=-1).min() > 2 * diff
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        assert not tv.numpy()[~active].any() and tv.numpy()[active].any()


def test_serve_step_matches_jax(tiny):
    _serve_step_matches_jax(tiny)


def test_serve_step_matches_jax_rvt_s(small):
    """RVT-S: stages 48/96/192/384 in heads of 24."""
    assert small[3]["params"]["backbone"]["stage1"]["block0_window"][
        "attn"]["qkv"]["kernel"].shape == (48, 144)
    _serve_step_matches_jax(small)


def test_serving_engine_answers_and_evicts(tiny):
    """Requests from two client threads, then an eviction: every answer
    is [n, 7] and finite, and the evicted slot's new stream starts from
    zero state (its answer equals the first answer of a fresh stream on
    the same frame)."""
    import threading
    _, tcfg, _, _, tdet = tiny
    step = make_serve_step(tdet, conf_threshold=0.0, device="cpu")
    shape = serve_input_shape(tcfg, 2)[1:]
    engine = ServingEngine(step, tdet.init_states(2), shape,
                           max_wait_ms=1.0, device="cpu")
    rng = np.random.default_rng(2)
    frames = {sid: _frames(rng, tcfg, 2) for sid in ("a", "b")}
    answers = {}

    def client(sid):
        answers[sid] = [engine.detect(sid, f, timeout=120)
                        for f in frames[sid]]

    try:
        threads = [threading.Thread(target=client, args=(sid,))
                   for sid in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        # "a" was used last before "b"'s last frame or with it; either
        # way a third stream evicts the least recently used one
        fresh = engine.detect("c", frames["a"][0], timeout=120)
        stats = engine.stats()
    finally:
        engine.close()
    assert stats["streams"] == 2 and 3 <= stats["steps"] <= 5
    for sid in frames:
        for a in answers[sid]:
            assert a.ndim == 2 and a.shape[1] == 7 and np.isfinite(a).all()
    np.testing.assert_allclose(fresh, answers["a"][0], rtol=1e-5, atol=1e-5)


def _eval_shape_tree(preset_dataset, size):
    cfg = j_experiment_preset(preset_dataset, size)
    det = JDetector(cfg.model, dtype=jnp.float32)
    shapes = jax.eval_shape(det.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    return cfg, jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _load_consumes_every_leaf(size):
    """Every leaf of a JAX tree at a preset's width lands in the port, in
    the port's layout; a leftover or a missing leaf raises."""
    _, tree = _eval_shape_tree("gen1", size)
    det = Detector(experiment_preset("gen1", size).model,
                   dtype=torch.float32, device="cpu")
    load_jax_variables(det, tree)
    p, bs = tree["params"], tree["batch_stats"]
    s1 = det.backbone.stage1
    np.testing.assert_array_equal(                      # Dense [in, out]
        s1.block0_window.attn.qkv.weight.numpy(),
        p["backbone"]["stage1"]["block0_window"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(                      # S2D stem HWIO
        s1.down.conv.weight.numpy(),
        p["backbone"]["stage1"]["down"]["conv"]["kernel"].transpose(3, 2, 0,
                                                                    1))
    np.testing.assert_array_equal(                      # LSTM [1,1,2C,4C]
        s1.lstm.gates.weight.numpy()[:, :, 0, 0],
        p["backbone"]["stage1"]["lstm"]["gates"]["kernel"][0, 0].T)
    np.testing.assert_array_equal(
        det.fpn.C3_p4.m0.conv2.bn.running_var.numpy(),
        bs["fpn"]["C3_p4"]["m0"]["conv2"]["bn"]["var"])
    np.testing.assert_array_equal(s1.block0_grid.ls2.numpy(),
                                  p["backbone"]["stage1"]["block0_grid"]
                                  ["ls2"])

    extra = {**tree, "params": {**p, "head": {**p["head"],
                                              "extra": {"bias": np.zeros(2)}}}}
    with pytest.raises(ValueError, match="no port tensor"):
        load_jax_variables(det, extra)
    head = dict(p["head"])
    head.pop("obj_pred0")
    with pytest.raises(ValueError, match="did not fill"):
        load_jax_variables(det, {**tree, "params": {**p, "head": head}})
    return det


def test_load_jax_variables_rvt_b_consumes_every_leaf():
    _load_consumes_every_leaf("base")


def test_load_jax_variables_rvt_s_consumes_every_leaf():
    """RVT-S: embed 48, heads of 24; the stage widths reach the port."""
    det = _load_consumes_every_leaf("small")
    assert [getattr(det.backbone, f"stage{k}").lstm.gates.dim
            for k in range(1, 5)] == [48, 96, 192, 384]
    assert det.backbone.stage4.block0_grid.attn.dim_head == 24


DEPLOY_MODULES = ("leod_tpu_torch.cli.export", "leod_tpu_torch.cli.serve",
                  "leod_tpu_torch.cli.import_raw",
                  "leod_tpu_torch.data.import_raw",
                  "leod_tpu_torch.data.psee", "leod_tpu_torch.native",
                  "leod_tpu_torch.ops.voxel")


def test_port_imports_neither_jax_nor_leod_tpu():
    """Importing every module of the port, and chip_smoke, in a fresh
    interpreter leaves jax, flax and leod_tpu out of sys.modules, and
    h5py too (the port imports it only where it opens an h5 file); the
    deployment modules (export, serve, ingestion, host ops) are among
    those imported, and importing them builds nothing."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import leod_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(leod_tpu_torch.__path__,\n"
        "                               'leod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'leod_tpu', 'h5py')]\n"
        f"missing = [m for m in {DEPLOY_MODULES!r} if m not in sys.modules]\n"
        "from leod_tpu_torch import native\n"
        "built = native._tried or native._lib is not None\n"
        "print(len([m for m in sys.modules if m.startswith('leod_tpu_')]))\n"
        "sys.exit(f'imported {bad[:5]}' if bad else\n"
        "         f'not imported {missing}' if missing else\n"
        "         'built the host library on import' if built else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 56       # every module loaded


def test_entry_points_need_a_card_unless_given_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    _, tcfg, _, _, tdet = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(tcfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_step(tdet)
    step = make_serve_step(tdet, device="cpu")
    shape = serve_input_shape(tcfg, 1)[1:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(step, tdet.init_states(1), shape)
    engine = ServingEngine(step, tdet.init_states(1), shape, device="cpu")
    engine.close()
