"""The yardstick's own parts: the frozen reference against the port's
plain path at a tiny size, the reference NMS against the port's, the
work counts against hand counts at RVT-B's stage shapes, and what the
harness and the reference import."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import bench, work
from portbench.reference import loss as ref_loss
from portbench.reference.model import (Anchors, Block, Numerics,
                                       fold_frames, reset_rows)
from portbench.reference.nms import postprocess

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tiny_config():
    with open(os.path.join(REPO, "portbench", "configs",
                           "rvt_b_gen1.json")) as f:
        c = json.load(f)
    c["preset"]["size"] = "tiny"
    c["model"].update(embed_dim=32, fpn_depth=0.33, partition_size=[2, 3],
                      in_res_hw=[64, 96])
    c["dataset"].update(resolution_hw=[64, 96], sequence_length=3)
    c["training"].update(precision="fp32", batch_size=2)
    return c


def _weights(cfg, seed=3):
    ref = bench.reference_model(cfg, "cpu")
    spec = {"layerscale": [0.05, 0.3], "pred_bias": -2.0, "pred_gain": 2.0,
            "reg_gain": 0.3}
    sd = bench.seeded_state(ref, seed, spec, "cpu")
    frames = torch.poisson(torch.full((2, 20, 64, 96), 0.3)).to(torch.uint8)
    bench.settle_bn(ref, sd, frames, 2, "cpu")
    ref.load_state_dict(sd)
    return ref, sd


def test_reference_forward_is_the_ports_plain_path():
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.models.layers import fold_ev_hw
    torch.manual_seed(0)
    cfg = _tiny_config()
    ref, sd = _weights(cfg)
    det = Detector(bench.port_config(cfg, "").model, dtype=torch.float32,
                   device="cpu")
    det.load_state_dict(sd)
    frames = torch.poisson(torch.full((3, 2, 20, 64, 96), 0.3))
    nm = Numerics("fp32")
    st, ps = ref.zero_states(2, "cpu"), det.init_states(2)
    with torch.no_grad():
        for t in range(3):
            x = fold_frames(frames[t], (64, 96))
            f, st = ref.backbone_step(x, st, nm)
            pf, ps = det.forward_backbone(fold_ev_hw(x), ps, plain=True)
        out = ref.detect(f, Anchors((64, 96), (8, 16, 32), "cpu"), nm,
                         train=False, sigmoid=True)
        pout, _ = det.forward_detect(pf)
    for (h, c), (ph, pc) in zip(st, ps):
        assert torch.allclose(h, ph, atol=1e-5) and \
            torch.allclose(c, pc, atol=1e-5)
    # fp32 rounding, grown through the FPN and head (activations ~100):
    # each channel within 1e-4 of its largest magnitude
    scale = out.abs().amax(dim=(0, 1)) + 1e-6
    assert bool(((out - pout).abs() <= 1e-4 * scale).all())


def test_reference_train_step_is_the_ports():
    """Loss and every gradient of one step from the same weights and
    batch, fp32, against `make_train_step`'s module path and loss."""
    from leod_tpu_torch.models.detector import Detector
    from leod_tpu_torch.models.layers import fold_ev_hw
    from leod_tpu_torch.train.step import _gather_frames, _scan_backbone
    torch.manual_seed(1)
    cfg = _tiny_config()
    ref, sd = _weights(cfg)
    det = Detector(bench.port_config(cfg, "").model, dtype=torch.float32,
                   device="cpu", trainable=True)
    det.load_state_dict(sd)
    L, B, M = 3, 2, 2
    raw = torch.poisson(torch.full((L, B, 20, 64, 96), 0.3))
    x = fold_frames(raw, (64, 96))
    frame_t = torch.tensor([[0, 2], [1, 2]])
    mask = torch.tensor([[True, True], [True, False]])
    labels = torch.zeros(B, M, 64, 7)
    labels[..., :3, 0] = torch.tensor([0.0, 1.0, 0.0])
    labels[..., :3, 1:5] = torch.tensor([[20.0, 20, 16, 24], [50, 30, 30, 20],
                                         [70, 40, 12, 12]])
    labels[..., :3, 5:] = 1.0
    nm = Numerics("fp32")
    anchors = Anchors((64, 96), (8, 16, 32), "cpu")
    states = reset_rows(ref.zero_states(B, "cpu"), torch.ones(B, dtype=bool))
    seq = []
    for t in range(L):
        f, states = ref.backbone_step(x[t], states, nm)
        seq.append(f)
    rows = torch.arange(B)[:, None]
    feats = []
    for lv in range(3):
        g = torch.stack([s[lv] for s in seq])[frame_t, rows]
        feats.append(g.reshape((-1,) + g.shape[2:]))
    out = ref.detect(feats, anchors, nm, train=True, sigmoid=False)
    loss, terms = ref_loss.yolox_loss(out, labels.reshape(-1, 64, 7),
                                      mask.reshape(-1), anchors.centers,
                                      anchors.strides, 2)
    names = [n for n, _ in ref.named_parameters()]
    grads = torch.autograd.grad(loss, list(ref.parameters()),
                                allow_unused=True)
    _, fs = _scan_backbone(det, det.init_states(B, torch.float32),
                           fold_ev_hw(x), remat="none")
    pout, _ = det.forward_detect(_gather_frames(fs, frame_t), train=True)
    ploss = det.loss(pout, labels.reshape(-1, 64, 7), mask.reshape(-1))
    ploss["loss"].backward()
    pg = dict(det.named_parameters())
    assert abs(loss.item() - ploss["loss"].item()) <= 1e-5 * abs(loss.item())
    for k in ("iou_loss", "conf_loss", "cls_loss", "num_fg"):
        assert abs(terms[k].item() - ploss[k].item()) <= 1e-5 * max(
            1.0, abs(terms[k].item())), k
    for n, g in zip(names, grads):
        want = pg[n].grad
        g = torch.zeros_like(want) if g is None else g
        want = torch.zeros_like(g) if want is None else want
        assert torch.allclose(g, want, atol=1e-4 * max(1.0, float(
            want.abs().max()))), n


def test_reference_optimizer_is_the_ports():
    from leod_tpu_torch.train.optim import make_optimizer
    cfg = bench.port_config(_tiny_config(), "")
    torch.manual_seed(2)
    p0 = torch.randn(50)
    a = torch.nn.Parameter(p0.clone())
    b = p0.clone()
    opt, _ = make_optimizer(cfg.training, [a])
    ref = ref_loss.AdamW([b], _tiny_config()["training"])
    for k in range(3):
        g = torch.randn(50) * 2
        a.grad = g.clone()
        opt.step()
        ref.step([g.clone()])
        assert torch.allclose(a.detach(), b, atol=1e-7), k


def test_reference_nms_is_the_ports():
    from leod_tpu_torch.ops.nms import postprocess as port_post
    g = torch.Generator().manual_seed(4)
    preds = torch.rand(6, 400, 7, generator=g)
    preds[..., :2] *= 100
    preds[..., 2:4] = preds[..., 2:4] * 30 + 4
    for conf in (0.1, 0.3):
        d, v = postprocess(preds, 2, conf, 0.45, 300, 200)
        pd, pv = port_post(preds, 2, conf, 0.45, 300, 200, plain=True)
        assert torch.equal(v, pv) and torch.equal(d, pd)


def test_work_counts_match_hand_counts():
    """The kernels' FLOPs at RVT-B's stage shapes against the products a
    block makes (FlopCounterMode over the reference block), and bytes
    against the count by hand for stage 1."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = json.load(open(os.path.join(REPO, "portbench", "configs",
                                      "rvt_b_gen1.json")))
    shapes = work.stage_shapes(cfg["model"])
    assert sorted(shapes) == [64, 128, 256, 512]
    assert shapes[64]["tokens"] == 64 * 80 and shapes[512]["tokens"] == 8 * 10
    for c, s in shapes.items():
        n_tok = 8 * s["tokens"]
        with torch.device("meta"):
            blk = Block(c, 32, 4, False)
            x = torch.zeros(n_tok // s["t"], s["t"], c)
            with FlopCounterMode(display=False) as fc:
                blk(x, Numerics("fp32"))
        fa, _ = work.attn_work(c, s["t"], n_tok, True)
        fm, _ = work.mlp_work(c, s["inner"], n_tok)
        assert fa + fm == fc.get_total_flops()
    _, b = work.attn_work(64, 80, 5120, False)
    assert b == (3 * 64 * 64 + 3 * 64) * 2 + 5120 * 128 * 2
    f, b = work.lstm_work(64, 5120)
    assert f == 2 * 5120 * 128 * 256
    assert b == (256 * 128 + 256) * 2 + 3 * 5120 * 64 * 2 + 2 * 5120 * 64 * 2
    t, by = work.bound(989e12, 1.0, work.PEAK_BF16)
    assert by == "operations" and abs(t - 1.0) < 1e-12


def test_forward_flops_count_every_stage():
    cfg = json.load(open(os.path.join(REPO, "portbench", "configs",
                                      "rvt_b_gen1.json")))
    bb, head = work.forward_flops(cfg)
    blocks = sum(work.attn_work(c, s["t"], s["tokens"], True)[0]
                 + work.mlp_work(c, s["inner"], s["tokens"])[0]
                 + work.lstm_work(c, s["tokens"])[0]
                 for c, s in work.stage_shapes(cfg["model"]).items())
    assert bb > blocks > 0 and head > 0


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program_or_jax():
    mods = _modules_after("import portbench.reference.model, "
                          "portbench.reference.loss, portbench.reference.nms")
    assert not mods & {"jax", "jaxlib", "flax", "optax", "orbax", "leod_tpu",
                       "leod_tpu_torch"}


def test_a_run_imports_no_jax(tmp_path):
    """A whole tiny cell on the CPU (every harness module a run loads,
    the port, the reference) leaves no module of JAX or the JAX package
    loaded."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); "
            "sys.path.insert(0, " + repr(os.path.join(REPO, "portbench",
                                                      "tests")) + ")\n"
            "import tiny, torch\n"
            "from portbench import bench\n"
            f"root = tiny.make_root({str(tmp_path / 'co')!r})\n"
            "for w in ('tiny_eval', 'tiny_train'):\n"
            "    cell = bench.find_cell(root, w)\n"
            "    run = bench.generator(cell).run(cell, 5, 0.5, False, 'cpu', "
            "bench.Clock())\n"
            "    assert bench.judge(run, cell.limits)[0], run.checks\n"
            "    for m in cell.end_to_end:\n"
            "        bench.read_metric(cell, m['name'], run)\n"
            "assert not bench.forbidden_modules(), bench.forbidden_modules()")
    mods = _modules_after(code)
    assert "leod_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "optax", "orbax", "leod_tpu"}


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "flax.linen", "optax",
                                  "orbax", "leod_tpu", "leod_tpu.ops"])
def test_forbidden_names_compare_whole(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in bench.forbidden_modules()


def test_the_port_is_not_a_forbidden_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "leod_tpu_torch_x", object())
    bad = bench.forbidden_modules()
    assert "leod_tpu_torch" not in bad and "leod_tpu_torch_x" not in bad
