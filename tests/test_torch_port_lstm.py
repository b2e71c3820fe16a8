"""The ConvLSTM update on its own: the port's `lstm_update_plain` (the plain
version that `lstm_update_kernel` is held against on the card) against the
JAX package's Pallas `fused_stage` with no block pairs, which runs only its
LSTM body `_lstm_update`, in interpret mode on the CPU. On CPU tensors the
`lstm_update` wrapper is its plain version and counts no launch, and
`fused_stage` reaches the update through it.

Inputs are made with numpy from a seed; the gate weights go across through
`load_jax_variables`. Tolerances: 1e-5 in float32 (the two sum the gate
product in other orders); in bf16 (x, h, c and the weights bf16, products
accumulated in fp32, h' and c' rounded once) one bf16 ulp of the largest
output, 2^-7 * max|ref|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import leod_tpu.ops.maxvit_pallas as jmp

from leod_tpu_torch.convert import load_jax_variables
from leod_tpu_torch.models.layers import _SplitGateConv
from leod_tpu_torch.ops import maxvit_cuda

H, W = 8, 10
PS = (4, 5)


def _inputs(dim, dtype, seed):
    """x, h, c [2, H, W, C] and the gates' JAX tree (kernel [1, 1, 2C, 4C],
    bias [4C]), as numpy float32; the port's gate module in `dtype`."""
    rng = np.random.default_rng(seed)
    x, h, c = (rng.normal(size=(2, H, W, dim)).astype(np.float32) * s
               for s in (1.0, 0.5, 0.5))
    tree = {"kernel": (rng.normal(size=(1, 1, 2 * dim, 4 * dim))
                       / np.sqrt(2 * dim)).astype(np.float32),
            "bias": rng.normal(size=(4 * dim,)).astype(np.float32) * 0.5}
    gates = _SplitGateConv(dim)
    load_jax_variables(gates, {"params": tree})
    return x, h, c, tree, gates.to(dtype)


def _pallas_lstm(x, h, c, tree, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a).astype(jd) for a in (x, h, c)]
    lstm = {k: jnp.asarray(v).astype(jd) for k, v in tree.items()}
    hn, cn = jmp.fused_stage(*args, [], lstm, PS, skip_first_norm=False,
                             interpret=True)
    return (np.asarray(hn.astype(jnp.float32)),
            np.asarray(cn.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [32, 64, 128])
def test_lstm_update_plain_matches_pallas(dim, dtype):
    """h' and c' of `lstm_update_plain` against the Pallas LSTM body, with
    everything in float32, or with x, h, c and the weights in bf16."""
    x, h, c, tree, gates = _inputs(dim, dtype, seed=dim)
    want_h, want_c = _pallas_lstm(x, h, c, tree, dtype)
    with torch.no_grad():
        got_h, got_c = maxvit_cuda.lstm_update_plain(
            *(torch.from_numpy(a).to(dtype) for a in (x, h, c)), gates)
    assert got_h.dtype == dtype and got_c.dtype == dtype
    for got, want in ((got_h, want_h), (got_c, want_c)):
        tol = (1e-5 if dtype == torch.float32
               else 2.0 ** -7 * float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)


def test_lstm_update_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `lstm_update` is `lstm_update_plain` exactly, with a
    bf16 and an fp32 cell state, and counts no launch."""
    x, h, c, _, gates = _inputs(64, torch.bfloat16, seed=3)
    xt, ht = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, h))
    before = maxvit_cuda.lstm_update.launches
    with torch.no_grad():
        for c_dtype in (torch.bfloat16, torch.float32):
            ct = torch.from_numpy(c).to(c_dtype)
            got = maxvit_cuda.lstm_update(xt, ht, ct, gates)
            want = maxvit_cuda.lstm_update_plain(xt, ht, ct, gates)
            assert got[1].dtype == c_dtype
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert maxvit_cuda.lstm_update.launches == before


def test_fused_stage_routes_through_lstm_update(monkeypatch):
    """`fused_stage` ends in one call of the `lstm_update` wrapper, whose
    output it returns; on the CPU that counts no launch of either."""
    x, h, c, _, gates = _inputs(32, torch.float32, seed=4)
    calls = []
    real = maxvit_cuda.lstm_update

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(maxvit_cuda, "lstm_update", spy)
    xt, ht, ct = (torch.from_numpy(a) for a in (x, h, c))
    before = (maxvit_cuda.fused_stage.launches, real.launches)
    with torch.no_grad():
        got = maxvit_cuda.fused_stage(xt, ht, ct, [], gates, PS, True)
        want = maxvit_cuda.lstm_update_plain(xt, ht, ct, gates)
    assert calls == [xt.shape]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (maxvit_cuda.fused_stage.launches, real.launches) == before
