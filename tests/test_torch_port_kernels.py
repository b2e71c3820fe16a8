"""The port's kernel wrappers on the CPU, where they run their plain
versions, against the JAX package's Pallas functions in interpret mode:
`fused_block_pair` and `fused_stage` at 2e-5 in float32 (heads of 32 at
RVT-T/B widths, heads of 24 at RVT-S widths), the NMS keep mask and
`postprocess` exactly. Inputs are made with numpy from a seed;
weights go through `load_jax_variables`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import leod_tpu.ops.maxvit_pallas as jmp
from leod_tpu.config import BackboneConfig as JBackboneConfig
from leod_tpu.models.backbone import RVTBackbone as JBackbone
from leod_tpu.models.backbone import init_states as j_init_states
from leod_tpu.models.layers import PartitionAttention as JPartitionAttention
from leod_tpu.ops.nms import nms_mask as j_nms_mask
from leod_tpu.ops.nms import postprocess as j_postprocess
from leod_tpu.ops.nms_pallas import nms_mask_pallas

from leod_tpu_torch.config import BackboneConfig
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.backbone import RVTBackbone
from leod_tpu_torch.models.layers import PartitionAttention
from leod_tpu_torch.ops import maxvit_cuda, nms_cuda
from leod_tpu_torch.ops.nms import postprocess

TOL = dict(rtol=2e-5, atol=2e-5)
H, W = 16, 20
PH, PW = 4, 5


def _np_tree(tree, rng):
    """numpy copy of a flax tree with LayerScale drawn at O(1), so the
    blocks' branches are not scaled down to 1e-5 in the comparison."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _np_tree(v, rng)
        elif k in ("ls1", "ls2"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _pair_modules(dim, skip, gated, rng, dim_head=32):
    x = rng.normal(size=(2, H, W, dim)).astype(np.float32)
    params = {}
    for i, (kind, sk) in enumerate((("window", skip), ("grid", False))):
        jm = JPartitionAttention(dim, (PH, PW), kind, skip_first_norm=sk,
                                 dim_head=dim_head, mlp_gated=gated)
        params[kind] = _np_tree(
            jm.init(jax.random.PRNGKey(i), jnp.asarray(x))["params"], rng)
    mods = torch.nn.ModuleDict({
        kind: PartitionAttention(dim, (PH, PW), kind,
                                 skip_first_norm=skip and kind == "window",
                                 dim_head=dim_head, mlp_gated=gated)
        for kind in ("window", "grid")})
    load_jax_variables(mods, {"params": params})
    return x, params, mods


@pytest.mark.parametrize("dim,skip,gated", [
    (64, False, False), (64, True, False), (64, False, True),
    (64, True, True), (32, True, False), (128, False, False)])
def test_fused_block_pair_matches_pallas(dim, skip, gated):
    """2 heads in all four (skip_first_norm, gated) cases, then 1 and 4
    heads."""
    rng = np.random.default_rng(dim + 2 * skip + gated)
    x, params, mods = _pair_modules(dim, skip, gated, rng)
    want = jmp.fused_block_pair(jnp.asarray(x), params["window"],
                                params["grid"], (PH, PW),
                                skip_first_norm=skip, gated=gated,
                                interpret=True)
    before = maxvit_cuda.fused_block_pair.launches
    with torch.no_grad():
        got = maxvit_cuda.fused_block_pair(
            torch.from_numpy(x), mods["window"], mods["grid"], (PH, PW),
            skip_first_norm=skip, gated=gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert maxvit_cuda.fused_block_pair.launches == before  # no kernel


@pytest.mark.parametrize("dim,skip,gated", [
    (48, True, False), (48, False, True), (96, False, False),
    (96, True, True)])
def test_fused_block_pair_matches_pallas_dim_head_24(dim, skip, gated):
    """RVT-S's first two stage widths, in heads of 24 (2 and 4 heads)."""
    rng = np.random.default_rng(dim + 2 * skip + gated)
    x, params, mods = _pair_modules(dim, skip, gated, rng, dim_head=24)
    want = jmp.fused_block_pair(jnp.asarray(x), params["window"],
                                params["grid"], (PH, PW),
                                skip_first_norm=skip, dim_head=24,
                                gated=gated, interpret=True)
    before = maxvit_cuda.fused_block_pair.launches
    with torch.no_grad():
        got = maxvit_cuda.fused_block_pair(
            torch.from_numpy(x), mods["window"], mods["grid"], (PH, PW),
            skip_first_norm=skip, dim_head=24, gated=gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert maxvit_cuda.fused_block_pair.launches == before  # no kernel


def test_fused_block_pair_rejects_mismatched_modules():
    _, _, mods = _pair_modules(32, True, False, np.random.default_rng(0))
    x = torch.zeros(1, H, W, 32)
    with pytest.raises(ValueError, match="skip_first_norm"):
        maxvit_cuda.fused_block_pair(x, mods["window"], mods["grid"],
                                     (PH, PW), skip_first_norm=False)
    with pytest.raises(ValueError, match="partition_size"):
        maxvit_cuda.fused_block_pair(x, mods["window"], mods["grid"],
                                     (2, 5), skip_first_norm=True)


def _fused_stage_matches_pallas(**common):
    """The whole backbone through the port's `fused_stage` (its plain
    version on the CPU) against the JAX backbone with fused="stage" and
    the Pallas `fused_stage` in interpret mode, from warm states: the
    four stage features and every (h, c)."""
    jcfg, tcfg = JBackboneConfig(**common), BackboneConfig(**common)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 64, 96, 20)).astype(np.float32) * 3)
    jb = JBackbone(jcfg, dtype=jnp.float32)
    v = {"params": _np_tree(jax.tree.map(np.asarray, jax.jit(jb.init)(
        jax.random.PRNGKey(0), x, j_init_states(jcfg, 2)))["params"], rng)}
    _, warm = jax.jit(jb.apply)(v, x, j_init_states(jcfg, 2))
    orig = jmp.fused_stage
    jmp.fused_stage = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        jf, jst = jb.apply(v, x, warm, fused="stage")
    finally:
        jmp.fused_stage = orig

    tb = RVTBackbone(tcfg)
    load_jax_variables(tb, v)
    before = maxvit_cuda.fused_stage.launches
    with torch.no_grad():
        tf, tst = tb(torch.tensor(np.asarray(x)),
                     tuple((torch.tensor(np.asarray(h)),
                            torch.tensor(np.asarray(c))) for h, c in warm))
    assert maxvit_cuda.fused_stage.launches == before
    for s in jf:
        np.testing.assert_allclose(tf[s].numpy(), np.asarray(jf[s]), **TOL,
                                   err_msg=str(s))
    for (th, tc), (jh, jc) in zip(tst, jst):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_fused_stage_matches_pallas_from_warm_states():
    """RVT-T widths: stages 32/64/128/256, heads of 32."""
    _fused_stage_matches_pallas(embed_dim=32, in_res_hw=(64, 96),
                                partition_size=(2, 3))


def test_fused_stage_matches_pallas_rvt_s_from_warm_states():
    """RVT-S widths: stages 48/96/192/384, heads of 24 (2/4/8/16)."""
    _fused_stage_matches_pallas(embed_dim=48, dim_head=24,
                                in_res_hw=(64, 96), partition_size=(2, 3))


def _sorted_boxes(rng, n, canvas=(320, 256)):
    ctr = rng.uniform(0, 1, (n, 2)) * np.asarray(canvas)
    wh = rng.uniform(6, 70, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_pallas_kernel_all_ids_equal(seed):
    """With all class ids equal (and with none), the port's keep mask is
    the Pallas kernel's, exactly."""
    rng = np.random.default_rng(seed)
    k = 300
    boxes = _sorted_boxes(rng, k)
    valid = rng.uniform(size=k) > 0.1
    want = np.asarray(nms_mask_pallas(jnp.asarray(boxes), 0.45,
                                      jnp.asarray(valid), interpret=True))
    for ids in (None, torch.full((k,), 1.0)):
        got = nms_cuda.nms_mask(torch.from_numpy(boxes), 0.45,
                                torch.from_numpy(valid), ids)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()       # the sweep suppressed some


@pytest.mark.parametrize("invalid", [(), (31, 50)])
def test_nms_staircase_matches_pallas_kernel(invalid):
    """A staircase of K = 100 boxes, box i 3 to the right of box i - 1
    and 10 wide, so that each overlaps only its neighbours above the
    threshold: kept and suppressed boxes alternate across the 32-box
    words of the CUDA sweep, and an invalid box in the chain suppresses
    nothing (at an even place it turns the alternation over). The port's
    keep mask is the Pallas kernel's, exactly."""
    k = 100
    x = np.arange(k, dtype=np.float32) * 3
    boxes = np.stack([x, np.zeros(k), x + 10, np.full(k, 10)], -1
                     ).astype(np.float32)
    valid = np.ones(k, bool)
    valid[list(invalid)] = False
    want = np.asarray(nms_mask_pallas(jnp.asarray(boxes), 0.45,
                                      jnp.asarray(valid), interpret=True))
    got = nms_cuda.nms_mask(torch.from_numpy(boxes), 0.45,
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    kept = valid.copy()              # box i falls only to a kept box i - 1
    for i in range(1, k):
        kept[i] &= not kept[i - 1]
    np.testing.assert_array_equal(want, kept)
    assert invalid == () or (kept[51] and not kept[52])   # 50 invalid


def test_nms_with_class_ids_matches_exact_class_mask():
    """Batched keep masks with two classes against the JAX `nms_mask`
    with its exact same-class mask, image by image."""
    rng = np.random.default_rng(3)
    b, k = 3, 200
    boxes = np.stack([_sorted_boxes(rng, k) for _ in range(b)])
    valid = rng.uniform(size=(b, k)) > 0.05
    ids = rng.integers(0, 2, (b, k)).astype(np.float32)
    got = nms_cuda.nms_mask(torch.from_numpy(boxes), 0.45,
                            torch.from_numpy(valid), torch.from_numpy(ids))
    for i in range(b):
        want = j_nms_mask(jnp.asarray(boxes[i]), 0.45, jnp.asarray(valid[i]),
                          jnp.asarray(ids[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("a,pre_topk,max_dets", [(400, 100, 50),
                                                 (60, 100, 80)])
def test_postprocess_matches_jax(a, pre_topk, max_dets):
    """Distinct scores, a confidence cut, top-k and the compaction to
    max_dets (cut and padded): dets and valid exactly equal."""
    rng = np.random.default_rng(a)
    b, n_cls = 2, 2
    preds = np.concatenate([
        rng.uniform(20, 300, (b, a, 2)), rng.uniform(6, 80, (b, a, 2)),
        rng.uniform(0, 1, (b, a, 1 + n_cls))], -1).astype(np.float32)
    jd, jv = j_postprocess(jnp.asarray(preds), num_classes=n_cls,
                           conf_threshold=0.05, nms_threshold=0.45,
                           pre_topk=pre_topk, max_dets=max_dets)
    td, tv = postprocess(torch.from_numpy(preds), num_classes=n_cls,
                         conf_threshold=0.05, nms_threshold=0.45,
                         pre_topk=pre_topk, max_dets=max_dets)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tv.any()
