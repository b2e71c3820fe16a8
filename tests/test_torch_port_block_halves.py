"""The two halves that the port's CUDA block kernels compute, in their
plain versions on the CPU: `block_attention_plain` (LayerNorm 1 and
attention before the output projection, `block_attention_kernel`) and
`block_mlp_plain` (projection to the end of the block,
`block_mlp_kernel`). Composed, they are the PartitionAttention block
exactly, and the composed pair holds the JAX package's Pallas
`fused_block_pair` in interpret mode at 1e-4 in float32. The wrappers
`block_attention` (NHWC in and out, the partition inside) and
`block_mlp` run their plain versions on CPU tensors and count no launch;
composed, window block then grid block, they hold the Pallas pair too.
Inputs are made with numpy from a seed; weights go across through
`load_jax_variables`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import leod_tpu.ops.maxvit_pallas as jmp
from leod_tpu.models.layers import PartitionAttention as JPartitionAttention

from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.layers import (PartitionAttention, grid_partition,
                                          grid_reverse, window_partition,
                                          window_reverse)
from leod_tpu_torch.ops import maxvit_cuda

TOL = dict(rtol=1e-4, atol=1e-4)
H, W = 16, 20
PH, PW = 4, 5
CASES = [(dim, skip, gated) for dim in (32, 64) for skip in (False, True)
         for gated in (False, True)]


def _np_tree(tree, rng):
    """numpy copy of a flax tree with LayerScale drawn at O(1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _np_tree(v, rng)
        elif k in ("ls1", "ls2"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _pair(dim, skip, gated, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, H, W, dim)).astype(np.float32)
    params = {}
    for i, (kind, sk) in enumerate((("window", skip), ("grid", False))):
        jm = JPartitionAttention(dim, (PH, PW), kind, skip_first_norm=sk,
                                 mlp_gated=gated)
        params[kind] = _np_tree(
            jm.init(jax.random.PRNGKey(seed + i), jnp.asarray(x))["params"],
            rng)
    mods = torch.nn.ModuleDict({
        kind: PartitionAttention(dim, (PH, PW), kind,
                                 skip_first_norm=skip and kind == "window",
                                 mlp_gated=gated)
        for kind in ("window", "grid")})
    load_jax_variables(mods, {"params": params})
    return x, params, mods


def _halves(tok, blk):
    return maxvit_cuda.block_mlp_plain(
        tok, maxvit_cuda.block_attention_plain(tok, blk), blk)


@pytest.mark.parametrize("dim,skip,gated", CASES)
def test_halves_compose_to_the_block(dim, skip, gated):
    """block_mlp_plain(x, block_attention_plain(x, blk), blk) is the
    block's forward in token layout, bit for bit in float32."""
    x, _, mods = _pair(dim, skip, gated, seed=dim + 2 * skip + gated)
    tok = window_partition(torch.from_numpy(x), PH, PW)
    with torch.no_grad():
        for blk in mods.values():
            assert torch.equal(_halves(tok, blk), blk(tok))


@pytest.mark.parametrize("dim,skip,gated", CASES)
def test_composed_pair_matches_pallas(dim, skip, gated):
    """Window block then grid block, each as its two halves, against the
    Pallas `fused_block_pair` in interpret mode."""
    x, params, mods = _pair(dim, skip, gated, seed=10 + dim + 2 * skip + gated)
    want = jmp.fused_block_pair(jnp.asarray(x), params["window"],
                                params["grid"], (PH, PW),
                                skip_first_norm=skip, gated=gated,
                                interpret=True)
    with torch.no_grad():
        y = window_reverse(_halves(window_partition(torch.from_numpy(x), PH,
                                                    PW), mods["window"]),
                           PH, PW, H, W)
        y = grid_reverse(_halves(grid_partition(y, PH, PW), mods["grid"]),
                         PH, PW, H, W)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)


def test_block_mlp_wrapper_runs_the_plain_half_on_the_cpu():
    """On CPU tensors the wrapper is its plain version and counts no
    launch; a module config that disagrees with the call raises."""
    x, _, mods = _pair(32, False, False, seed=3)
    tok = torch.from_numpy(x).reshape(-1, 32)
    blk = mods["grid"]
    with torch.no_grad():
        o = maxvit_cuda.block_attention_plain(tok[None], blk)[0]
        before = maxvit_cuda.block_mlp.launches
        got = maxvit_cuda.block_mlp(tok, o, blk)
        assert torch.equal(got, maxvit_cuda.block_mlp_plain(tok, o, blk))
    assert maxvit_cuda.block_mlp.launches == before
    with pytest.raises(ValueError, match="act/gated"):
        maxvit_cuda.block_mlp(tok, o, blk, gated=True)


@pytest.mark.parametrize("grid_kind", [False, True])
@pytest.mark.parametrize("skip", [False, True])
def test_block_attention_wrapper_runs_the_plain_half_on_the_cpu(grid_kind,
                                                                skip):
    """On a CPU tensor `block_attention` is the partition, then
    `block_attention_plain`, then the reverse, and counts no launch."""
    x, _, mods = _pair(64, skip, False, seed=5 + 2 * grid_kind + skip)
    blk = mods["grid" if grid_kind else "window"]
    part, rev = ((grid_partition, grid_reverse) if grid_kind
                 else (window_partition, window_reverse))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        before = maxvit_cuda.block_attention.launches
        got = maxvit_cuda.block_attention(xt, blk, grid_kind)
        want = rev(maxvit_cuda.block_attention_plain(part(xt, PH, PW), blk),
                   PH, PW, H, W)
    assert maxvit_cuda.block_attention.launches == before
    assert got.shape == xt.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dim,skip,gated", CASES)
def test_wrapped_halves_match_pallas(dim, skip, gated):
    """`block_mlp(x, block_attention(x, blk, ...), blk)` on the NHWC map,
    window block then grid block, holds the Pallas `fused_block_pair` in
    interpret mode."""
    x, params, mods = _pair(dim, skip, gated, seed=30 + dim + 2 * skip + gated)
    want = jmp.fused_block_pair(jnp.asarray(x), params["window"],
                                params["grid"], (PH, PW),
                                skip_first_norm=skip, gated=gated,
                                interpret=True)
    y = torch.from_numpy(x)
    with torch.no_grad():
        for kind in ("window", "grid"):
            blk = mods[kind]
            y = maxvit_cuda.block_mlp(
                y, maxvit_cuda.block_attention(y, blk, kind == "grid"), blk,
                gated=gated)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
