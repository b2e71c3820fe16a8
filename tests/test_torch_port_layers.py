"""The PyTorch port's layers, backbone, FPN and head against the JAX
package on the CPU in float32: the same numpy-made inputs and the same
weights (through `leod_tpu_torch.convert.load_jax_variables`), compared
at 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import leod_tpu.models.layers as jl
from leod_tpu.config import (BackboneConfig as JBackboneConfig,
                             FPNConfig as JFPNConfig,
                             HeadConfig as JHeadConfig,
                             ModelConfig as JModelConfig)
from leod_tpu.models.backbone import RVTBackbone as JBackbone
from leod_tpu.models.backbone import init_states as j_init_states
from leod_tpu.models.detector import Detector as JDetector

import leod_tpu_torch.models.layers as tl
from leod_tpu_torch.config import (BackboneConfig, FPNConfig, HeadConfig,
                                   ModelConfig)
from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.backbone import RVTBackbone
from leod_tpu_torch.models.backbone import init_states as t_init_states
from leod_tpu_torch.models.detector import Detector

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_stats(variables, rng):
    """Non-trivial BN running stats and LayerScale, so that those
    parameters are actually exercised by the comparison."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("mean", "ls1", "ls2"):
                out[k] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(_np(variables))


def _load(module, variables):
    load_jax_variables(module, variables)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 12, 5)).astype(np.float32)
    for part, rev in (("window_partition", "window_reverse"),
                      ("grid_partition", "grid_reverse")):
        jt = getattr(jl, part)(jnp.asarray(x), 2, 3)
        tt = getattr(tl, part)(_t(x), 2, 3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(
            getattr(tl, rev)(tt, 2, 3, 8, 12).numpy(), x)
    up = jl.upsample2x_nearest(jnp.asarray(x))
    np.testing.assert_array_equal(tl.upsample2x_nearest(_t(x)).numpy(),
                                  np.asarray(up))


@pytest.mark.parametrize("kind", ["window", "grid"])
@pytest.mark.parametrize("skip,gated", [(False, False), (True, False),
                                        (False, True)])
def test_partition_attention_tokens(kind, skip, gated):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 20, 64)).astype(np.float32)
    jm = jl.PartitionAttention(64, (4, 5), kind, skip_first_norm=skip,
                               mlp_gated=gated)
    v = _perturb_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               tokens=True), rng)
    want = jm.apply(v, jnp.asarray(x), tokens=True)
    tm = _load(tl.PartitionAttention(64, (4, 5), kind, skip_first_norm=skip,
                                     mlp_gated=gated), v)
    _close(tm(_t(x)), want)


@pytest.mark.parametrize("layout", ["raw", "width", "hw"])
def test_s2d_stem_layouts(layout):
    """The stride-4 stem accepts all three input layouts, each equal to
    the JAX module on the raw layout."""
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 30, (2, 32, 48, 20)).astype(np.float32)
    jm = jl.ConvDownsample(32, 4, in_channels=20)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(raw)))
    want = jm.apply(v, jnp.asarray(raw))
    x = {"raw": raw, "width": tl.fold_ev_width(raw),
         "hw": tl.fold_ev_hw(raw)}[layout]
    tm = _load(tl.ConvDownsample(20, 32, 4), v)
    _close(tm(_t(np.ascontiguousarray(x))), want)


@pytest.mark.parametrize("affine", [True, False])
def test_conv_downsample_stride2(affine):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    jm = jl.ConvDownsample(32, 2, norm_affine=affine)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = _load(tl.ConvDownsample(16, 32, 2, norm_affine=affine), v)
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("dws,only_hidden", [(False, True), (True, True),
                                             (True, False)])
def test_convlstm_cell(dws, only_hidden):
    rng = np.random.default_rng(4)
    x, h0, c0 = (rng.normal(size=(2, 6, 10, 16)).astype(np.float32)
                 for _ in range(3))
    jm = jl.ConvLSTMCell(16, dws_conv=dws, dws_conv_only_hidden=only_hidden)
    args = (jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)))
    v = _np(jm.init(jax.random.PRNGKey(0), *args))
    jh, jc = jm.apply(v, *args)
    tm = _load(tl.ConvLSTMCell(16, dws, only_hidden), v)
    th, tc = tm(_t(x), (_t(h0), _t(c0)))
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("depthwise", [False, True])
def test_csp_layer(depthwise):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 10, 24)).astype(np.float32)
    jm = jl.CSPLayer(32, n=2, depthwise=depthwise)
    v = _perturb_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = _load(tl.CSPLayer(24, 32, n=2, depthwise=depthwise), v)
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


def _tiny_backbone_cfgs(**kw):
    common = dict(embed_dim=32, in_res_hw=(64, 96), partition_size=(2, 3),
                  **kw)
    return JBackboneConfig(**common), BackboneConfig(**common)


@pytest.mark.parametrize("kw", [{}, {"lstm_dws_conv": True}])
def test_backbone_warm_states(kw):
    """Features and (h, c) over two timesteps from warm states: the port
    (fused_stage / fused_block_pair, plain on the CPU) against the JAX
    token-layout default path."""
    jcfg, tcfg = _tiny_backbone_cfgs(**kw)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(2, 2, 64, 96, 20)).astype(np.float32) * 3
    jb = JBackbone(jcfg, dtype=jnp.float32)
    jst = j_init_states(jcfg, 2, jnp.float32)
    v = _perturb_stats(jax.jit(jb.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(xs[0]), jst), rng)
    tb = _load(RVTBackbone(tcfg), v)
    tst = t_init_states(tcfg, 2)
    apply = jax.jit(jb.apply)
    with torch.no_grad():
        for t in range(2):
            jf, jst = apply(v, jnp.asarray(xs[t]), jst)
            tf, tst = tb(_t(xs[t]), tst)
    for s in jf:
        _close(tf[s], jf[s])
    for (th, tc), (jh, jc) in zip(tst, jst):
        _close(th, jh)
        _close(tc, jc)


def test_fpn_head_decode():
    """PAFPN + YOLOX head + decode of the whole Detector at the tiny
    config, with perturbed BN statistics."""
    jcfg, tcfg = _tiny_backbone_cfgs()
    jm = JModelConfig(backbone=jcfg, fpn=JFPNConfig(depth=0.33),
                      head=JHeadConfig(num_classes=2))
    tm = ModelConfig(backbone=tcfg, fpn=FPNConfig(depth=0.33),
                     head=HeadConfig(num_classes=2))
    jdet = JDetector(jm, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    v = _perturb_stats(jdet.init(jax.random.PRNGKey(0), batch_size=1), rng)
    tdet = Detector(tm, dtype=torch.float32, device="cpu")
    load_jax_variables(tdet, v)
    feats = {s: rng.normal(size=(2, 64 // 2 ** (s + 1), 96 // 2 ** (s + 1),
                                 32 * 2 ** (s - 1))).astype(np.float32)
             for s in (1, 2, 3, 4)}
    want, _ = jax.jit(jdet.forward_detect)(
        v, {s: jnp.asarray(f) for s, f in feats.items()})
    got, _ = tdet.forward_detect({s: _t(f) for s, f in feats.items()})
    _close(got, want)
