"""The port's deployment path on the CPU in float32: the serving step
exported with `torch.export` (the kernels as `leod_tpu_torch::` custom
ops), saved, loaded and run against the live step and against the JAX
package's exported artifact from the same weights; `artifact_meta`,
`zero_states_like` and the platforms; the export and serve CLIs; and one
HTTP round trip through each package's server."""
import base64
import importlib.util
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from leod_tpu.serve import ServingEngine as JServingEngine
from leod_tpu.serve import artifact_meta as j_artifact_meta
from leod_tpu.serve import export_serve_step as j_export_serve_step
from leod_tpu.serve import load_artifact as j_load_artifact
from leod_tpu.serve import save_artifact as j_save_artifact
from leod_tpu.serve import zero_states_like as j_zero_states_like

from leod_tpu_torch.cli import export as cli_export
from leod_tpu_torch.cli import serve as cli_serve
from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
from leod_tpu_torch.serve import (ServingEngine, artifact_meta,
                                  export_platforms, export_serve_step,
                                  load_artifact, load_artifact_exported,
                                  make_serve_step, save_artifact,
                                  zero_states_like)

from test_torch_port_serve import _frames, _models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
ROUNDTRIP = dict(rtol=1e-5, atol=1e-6)     # tests/test_serve.py:126-129
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
OPS = ("block_attention", "block_mlp", "block_mlp_tp", "block_residual",
       "lstm_update", "nms_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several workers share the machine's cores: torch runs on one
    thread in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory, _one_torch_thread):
    """RVT-T widths at 64 x 96 (`test_torch_port_serve._models`), both
    packages' serve steps exported from the same JAX variables at
    conf 0, B = 2, and saved."""
    jcfg, tcfg, jdet, v, tdet = _models("tiny")
    out = tmp_path_factory.mktemp("deploy")
    path = str(out / "model.pt2")
    ep = export_serve_step(tdet, tcfg, B, conf_threshold=0.0)
    save_artifact(ep, path, artifact_meta(tcfg, B, True, 0.0))
    jpath = str(out / "model.stablehlo")
    jexp = j_export_serve_step(jdet, v, jcfg, B, conf_threshold=0.0)
    j_save_artifact(jexp, jpath, j_artifact_meta(jcfg, B, True, 0.0))
    j_step, _ = j_load_artifact(jpath)
    return dict(jcfg=jcfg, tcfg=tcfg, jdet=jdet, tdet=tdet, ep=ep,
                path=path, jexp=jexp, jpath=jpath, j_step=j_step)


def _op_counts(ep):
    counts = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if name.startswith("leod_tpu_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def test_exported_graph_holds_the_four_ops(exported):
    """The backbone and the NMS are the custom ops in the saved program:
    a block and a ConvLSTM launch per stage's pair and stage, one NMS."""
    ep, _ = load_artifact_exported(exported["path"])
    bb = exported["tcfg"].model.backbone
    pairs = sum(bb.num_blocks)
    assert _op_counts(ep) == {"block_attention": 2 * pairs,
                              "block_mlp": 2 * pairs,
                              "lstm_update": len(bb.num_blocks),
                              "nms_mask": 1}


def test_artifact_equals_live_step(exported):
    """Two steps with a reset and an idle row: the loaded artifact's
    states and dets against the live `make_serve_step`, from the
    artifact's own zero states."""
    tcfg, tdet = exported["tcfg"], exported["tdet"]
    step_fn, meta = load_artifact(exported["path"], device="cpu")
    assert meta["platforms"] == ["cpu"]
    live = make_serve_step(tdet, conf_threshold=0.0, device="cpu")
    ep, _ = load_artifact_exported(exported["path"])
    st_a = tdet.init_states(B)
    st_b = zero_states_like(ep, device="cpu")
    rng = np.random.default_rng(4)
    for reset, active in (([1, 1], [1, 1]), ([0, 1], [1, 0])):
        ev = torch.from_numpy(_frames(rng, tcfg, B))
        reset, active = torch.tensor(reset, dtype=torch.bool), \
            torch.tensor(active, dtype=torch.bool)
        st_a, d_a, v_a = live(st_a, ev, reset, active)
        st_b, d_b, v_b = step_fn(st_b, ev, reset, active)
        np.testing.assert_array_equal(v_b.numpy(), v_a.numpy())
        np.testing.assert_allclose(d_b.numpy(), d_a.numpy(), **ROUNDTRIP)
        for (ha, ca), (hb, cb) in zip(st_a, st_b):
            np.testing.assert_allclose(hb.numpy(), ha.numpy(), **ROUNDTRIP)
            np.testing.assert_allclose(cb.numpy(), ca.numpy(), **ROUNDTRIP)
        assert v_a[0].any()


def test_artifact_matches_jax_artifact(exported):
    """The port's artifact against the JAX package's `export_serve_step`
    artifact from the same weights over three steps: states and dets
    within 1e-4, valid exact."""
    tcfg = exported["tcfg"]
    step_fn, _ = load_artifact(exported["path"], device="cpu")
    j_step = exported["j_step"]
    ep, _ = load_artifact_exported(exported["path"])
    st, jst = zero_states_like(ep, device="cpu"), \
        j_zero_states_like(exported["jexp"])
    rng = np.random.default_rng(7)
    for reset, active in (([1, 1], [1, 1]), ([0, 0], [1, 1]),
                          ([1, 0], [0, 1])):
        ev = _frames(rng, tcfg, B)
        reset, active = np.asarray(reset, bool), np.asarray(active, bool)
        jst, jd, jv = j_step(jst, ev, reset, active)
        st, d, v = step_fn(st, torch.from_numpy(ev),
                           torch.from_numpy(reset), torch.from_numpy(active))
        for (h, c), (jh, jc) in zip(st, jst):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **JAX_TOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), **JAX_TOL)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **JAX_TOL)


def test_meta_states_and_platforms(exported, tmp_path):
    """`artifact_meta` equals JAX's key for key; `zero_states_like` has
    the live table's shapes and dtypes (and JAX's shapes); "tpu"
    raises; an artifact for the card alone refuses the CPU."""
    tcfg, jcfg, tdet = exported["tcfg"], exported["jcfg"], exported["tdet"]
    for fold, conf in ((True, None), (False, 0.25)):
        assert artifact_meta(tcfg, 4, fold, conf) == \
            j_artifact_meta(jcfg, 4, fold, conf)
    ep, _ = load_artifact_exported(exported["path"])
    got = zero_states_like(ep, device="cpu")
    want = tdet.init_states(B)
    jwant = jax.tree.leaves(j_zero_states_like(exported["jexp"]))
    for a, b, j in zip(jax.tree.leaves(got), jax.tree.leaves(want), jwant):
        assert a.shape == b.shape == j.shape and a.dtype == b.dtype
        assert not a.any()
    assert zero_states_like(det=tdet, batch_size=3)[0][0].shape[0] == 3

    assert export_platforms(("gpu", "cuda", "CPU"), tdet) == ("cuda", "cpu")
    assert export_platforms(None, tdet) == ("cpu",)
    with pytest.raises(ValueError, match="no TPU"):
        export_platforms(("tpu",), tdet)
    ep.platforms = export_platforms(("gpu",), tdet)
    path = str(tmp_path / "cuda_only.pt2")
    save_artifact(ep, path, artifact_meta(tcfg, B, True))
    with open(path + ".json") as f:
        assert json.load(f)["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="exported for"):
        load_artifact(path, device="cpu")


@pytest.mark.parametrize("op", OPS)
def test_custom_op_opcheck(op):
    """`torch.library.opcheck` of each of the six ops (defined in C++) on
    CPU tensors: schema, Meta implementation, and that the CPU
    implementation counts no launch."""
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    c = 32
    wrappers = (maxvit_cuda.WRAPPERS + maxvit_cuda.TP_WRAPPERS
                + nms_cuda.WRAPPERS)
    before = {w.__name__: w.launches for w in wrappers}
    args = {
        "block_attention": (t(2, 4, 6, c), t(c), t(c), t(3 * c, c), t(3 * c),
                            32, 2, 3, True, 1e-5, 0),
        "block_mlp": (t(2, 4, 6, c), t(2, 4, 6, c), t(c, c), t(c), t(c),
                      t(c), t(c), t(4 * c, c), t(4 * c), t(c, 4 * c), t(c),
                      t(c), "gelu", False, 1e-5, 0),
        "lstm_update": (t(2, 4, 6, c), t(2, 4, 6, c), t(2, 4, 6, c),
                        t(4 * c, 2 * c, 1, 1), t(4 * c), 0),
        "nms_mask": (torch.sort(t(2, 16, 4).abs() * 10, -1).values, 0.45,
                     torch.from_numpy(rng.uniform(size=(2, 16)) < 0.8),
                     torch.from_numpy(rng.integers(0, 2, (2, 16))).float()),
        # the model axis's two ops: x bf16-shaped rows and a, p in fp32
        "block_mlp_tp": (t(2, 4, 6, c), t(2, 4, 6, c), t(c), t(c), t(c),
                         t(c), t(4 * c, c), t(4 * c), t(c, 4 * c), "gelu",
                         False, 1e-5, 0),
        "block_residual": (t(2, 4, 6, c), t(2, 4, 6, c), t(c), t(c)),
    }[op]
    torch.library.opcheck(getattr(torch.ops.leod_tpu_torch, op).default,
                          args)
    after = {w.__name__: w.launches for w in wrappers}
    assert after == before


def test_cli_export_and_serve_flags(tmp_path):
    """`cli.export` at RVT-T's full Gen1 width from seed 0 with the
    export-time knobs, `cli.serve` over its artifact and live from a
    checkpoint, and every refusal: no weights, a TPU platform, an orbax
    directory, and knobs fixed at export time given to the server."""
    out = str(tmp_path / "tiny.pt2")
    base = ["--synthetic", "--size", "tiny", "--cpu", "--fp32",
            "--batch-size", "2", "--out", out]
    assert cli_export.main(base + ["--conf", "0.25", "--raw-layout",
                                   "--platforms", "cpu,gpu"]) == out
    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta["conf_threshold"] == 0.25 and meta["fold_hw"] == [1, 1]
    assert meta["frame_shape"] == [256, 320, 20]
    assert meta["platforms"] == ["cpu", "cuda"]

    with pytest.raises(SystemExit):
        cli_export.main(["--size", "tiny", "--cpu", "--out", out])
    with pytest.raises(ValueError, match="no TPU"):
        cli_export.main(base + ["--platforms", "tpu"])
    with pytest.raises(ValueError, match="orbax"):
        cli_export.main(base[1:] + ["--ckpt", str(tmp_path)])

    ap = cli_serve.build_parser()
    for extra in (["--conf", "0.1"], ["--fp32"], ["--batch-size", "4"]):
        with pytest.raises(SystemExit):
            cli_serve.open_engine(ap.parse_args(
                ["--artifact", out, "--cpu"] + extra), ap)
    with pytest.raises(SystemExit):
        cli_serve.open_engine(ap.parse_args(["--cpu"]), ap)
    engine, meta = cli_serve.open_engine(ap.parse_args(
        ["--artifact", out, "--cpu", "--max-wait-ms", "0"]), ap)
    try:
        assert engine.batch_size == 2 and engine.frame_shape == (256, 320, 20)
        fr = np.zeros(engine.frame_shape, np.uint8)
        assert engine.detect("a", fr).shape[1] == 7
    finally:
        engine.close()

    from leod_tpu_torch.config import experiment_preset
    from leod_tpu_torch.models.detector import Detector
    det = Detector(experiment_preset("gen1", "tiny").model,
                   dtype=torch.float32, device="cpu", seed=3)
    ckpt = str(tmp_path / "ckpt_last.pt")
    torch.save({"model": det.state_dict()}, ckpt)
    engine, meta = cli_serve.open_engine(ap.parse_args(
        ["--ckpt", str(tmp_path / "ckpt_last"), "--size", "tiny", "--cpu",
         "--fp32", "--batch-size", "3", "--conf", "0.2"]), ap)
    engine.close()
    assert engine.batch_size == 3 and meta["conf_threshold"] == 0.2
    assert engine.frame_shape == (64, 80, 320)


def _jax_serve_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_cli_serve", os.path.join(REPO, "cli", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/detect",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_matches_jax_server(exported):
    """The same request bodies to the port's server over its artifact and
    to `cli/serve.py`'s server over the JAX artifact: the same boxes
    (within the 1e-4 tolerance and the 4-decimal rounding), classes and
    health fields; 400 and 404 alike."""
    tcfg = exported["tcfg"]
    ep, meta = load_artifact_exported(exported["path"])
    engine = ServingEngine(load_artifact(exported["path"], "cpu")[0],
                           zero_states_like(ep, device="cpu"),
                           meta["frame_shape"], max_wait_ms=0.0,
                           device="cpu")
    jexp = exported["jexp"]
    with open(exported["jpath"] + ".json") as f:
        jmeta = json.load(f)
    jengine = JServingEngine(exported["j_step"], j_zero_states_like(jexp),
                             jmeta["frame_shape"], max_wait_ms=0.0)
    servers = [cli_serve.make_server(engine, meta, "127.0.0.1", 0),
               _jax_serve_cli().make_server(jengine, jmeta, "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for th in threads:
        th.start()
    ports = [s.server_address[1] for s in servers]
    rng = np.random.default_rng(11)
    bodies = [{"stream": sid, "frame_b64": base64.b64encode(
        _frames(rng, tcfg, 1)[0].tobytes()).decode()}
        for sid in ("a", "b", "a")]
    try:
        for body in bodies:
            got, want = (_post(p, body) for p in ports)
            assert got["classes"] == want["classes"] == ["car", "pedestrian"]
            g, w = np.asarray(got["boxes"]), np.asarray(want["boxes"])
            assert g.shape == w.shape and len(g) > 0
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-4)
        health = [_get(p, "/v1/health") for p in ports]
        for key in ("status", "steps", "streams", "slots", "frame_shape"):
            assert health[0][1][key] == health[1][1][key], key
        for path in ("/v2/x",):
            assert _get(ports[0], path)[0] == _get(ports[1], path)[0] == 404
        bad = {"stream": "a", "frame_b64": base64.b64encode(b"xx").decode()}
        codes = []
        for p in ports:
            try:
                _post(p, bad)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert codes == [400, 400]
    finally:
        for s in servers:
            s.shutdown()
        engine.close()
        jengine.close()
