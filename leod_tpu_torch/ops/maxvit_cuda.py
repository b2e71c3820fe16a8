"""Ports of the Pallas kernels `fused_block_pair` and `fused_stage`
(`leod_tpu/ops/maxvit_pallas.py:254,206`) to hand-written CUDA for
Hopper (`csrc/maxvit.cu`).

Each wrapper dispatches on where its tensor lies: on the CPU it runs the
plain PyTorch version (the token-layout path of the modules,
`leod_tpu/models/backbone.py:89-107`); on a CUDA tensor it launches the
kernels or raises. Each wrapper counts the calls in which it launched
kernels in `.launches`; `block_attention.plan`, `block_mlp.plan` and
`lstm_update.plan` keep how its last launch dealt out the work. While
tracing records (`timing.py`), `block_mlp` also counts its plan
(`block_mlp.tiles`, `.split_tiles`, `.ctas`, and by width).

On the card, a block is two launches: `block_attention` (LN1 once per
token, q|k|v on wgmma fed by TMA, attention in registers, a CTA per
group of windows and heads; where windows are few, the head groups of a
window group are a cluster sharing LN1; plain version
`block_attention_plain`) and `block_mlp` (projection, LayerScale,
residual, LN2, MLP, LayerScale, residual, per token, on wgmma fed by TMA:
one wave of persistent CTAs, two warpgroups a CTA, which take a row tile
each or split one tile's columns; where few tokens leave the card empty,
a cluster of CTAs shares each unit's hidden dim; plain version
`block_mlp_plain`). `fused_stage` runs its pairs so
and then the ConvLSTM update `lstm_update` (the gate product on wgmma fed
by TMA, the gates in registers; where rows are few and K long, a cluster
of CTAs splits K; plain version `lstm_update_plain`). The kernels take bf16
activations and weights and accumulate in fp32, at the widths and head
widths of RVT-T, RVT-S and RVT-B (`kAttnShapes`, `kKernelDims` in
`csrc/torch_ops.cpp`, which alone decides what the kernels take); any
other shape raises on the card.

The five launches are custom ops, `leod_tpu_torch::block_attention`,
`::block_mlp`, `::block_mlp_tp`, `::block_residual` and `::lstm_update`,
over flat tensors and scalars, defined and implemented in C++
(`csrc/torch_ops.cpp`, built and loaded by `_build.load()` at the first
use): the CPU implementation is the plain version, the CUDA one checks
what the kernel takes, launches it or raises, and counts the launch, and
a Meta implementation gives `torch.export` the output's shape and dtype.
The wrappers below call the ops, so a graph exported from the serving
step (`serve.py` `export_serve_step`) holds them, launches counted from
such a graph are real launches, and the artifact that carries the
library (`artifact.py`) runs them without this package. The `*_plain`
functions are the readable reference the C++ CPU implementations are
held to.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .. import timing
from ..parallel import space, tensor
from ..models.layers import (PartitionAttention, _SplitGateConv,
                             block_pair_tokens, mlp_apply, mlp_hidden)

def _check_block(blk: PartitionAttention, skip_first_norm: bool,
                 dim_head: int, act: str, gated: bool) -> None:
    if (blk.skip_first_norm != skip_first_norm
            or blk.attn.dim_head != dim_head or blk.mlp.act != act
            or blk.mlp.gated != gated):
        raise ValueError("block module config disagrees with the call's "
                         "skip_first_norm/dim_head/act/gated")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _norm1(blk: PartitionAttention):
    return (None, None) if blk.skip_first_norm else (blk.norm1.weight,
                                                     blk.norm1.bias)


def _mlp_tp_weights(blk: PartitionAttention) -> tuple:
    """The weights `block_mlp_kernel`'s model-axis mode reads."""
    mlp = blk.mlp
    return (blk.attn.proj.bias, blk.ls1, blk.norm2.weight, blk.norm2.bias,
            mlp.proj_in.weight, mlp.proj_in.bias, mlp.proj_out.weight)


def _mlp_weights(blk: PartitionAttention) -> tuple:
    """The weights `block_mlp_kernel` reads, in the op's order."""
    attn, mlp = blk.attn, blk.mlp
    return (attn.proj.weight, attn.proj.bias, blk.ls1, blk.norm2.weight,
            blk.norm2.bias, mlp.proj_in.weight, mlp.proj_in.bias,
            mlp.proj_out.weight, mlp.proj_out.bias, blk.ls2)


def _mlp_fn(x, o, proj_w, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w,
            out_b, ls2, act: str, gated: bool, eps: float) -> torch.Tensor:
    y = F.linear(o, proj_w, proj_b)
    x = x + (y if ls1 is None else y * ls1)
    y = mlp_apply(F.layer_norm(x, (x.shape[-1],), norm_w, norm_b, eps),
                  in_w, in_b, out_w, out_b, act, gated)
    return x + (y if ls2 is None else y * ls2)


def _lstm_fn(x, h_prev, c_prev, weight, bias
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    d = x.shape[-1]
    k = weight.reshape(weight.shape[0], -1).float()
    mix = (F.linear(x.float(), k[:, :d])
           + F.linear(h_prev.to(x.dtype).float(), k[:, d:]) + bias.float())
    f, i, o = torch.sigmoid(mix[..., :3 * d]).chunk(3, dim=-1)
    c = f * c_prev.float() + i * torch.tanh(mix[..., 3 * d:])
    return (o * torch.tanh(c)).to(x.dtype), c.to(c_prev.dtype)


def _mlp_tp_fn(x, a, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w,
               act: str, gated: bool, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    y = (a if proj_b is None else a + proj_b.float()).to(x.dtype)
    x = x + (y if ls1 is None else y * ls1)
    h = mlp_hidden(F.layer_norm(x, (x.shape[-1],), norm_w, norm_b, eps),
                   in_w, in_b, act, gated)
    return x, F.linear(h.float(), out_w.float())


def _residual_fn(x, p, out_b, ls2) -> torch.Tensor:
    y = (p if out_b is None else p + out_b.float()).to(x.dtype)
    return x + (y if ls2 is None else y * ls2)


def block_attention_plain(x: torch.Tensor,
                          blk: PartitionAttention) -> torch.Tensor:
    """The half of a block that `block_attention_kernel` computes, on
    partitioned tokens [N, T, C]: LayerNorm 1 (unless skipped) and
    attention up to, not including, the output projection, of the
    block's heads ([N, T, heads * dim_head]: all of them, or a model
    rank's shard)."""
    return blk.attn.core(x if blk.skip_first_norm else blk.norm1(x))


def block_mlp_plain(x: torch.Tensor, o: torch.Tensor,
                    blk: PartitionAttention) -> torch.Tensor:
    """The per-token half that `block_mlp_kernel` computes, on any
    [..., C]: the output projection of the attention output `o`,
    LayerScale 1, residual x, LayerNorm 2, MLP, LayerScale 2, residual.
    `block_mlp_plain(x, block_attention_plain(x, blk), blk)` is
    `blk(x)`."""
    return _mlp_fn(x, o, *_mlp_weights(blk), blk.mlp.act, blk.mlp.gated,
                   blk.norm2.eps)


def block_mlp_tp_plain(x: torch.Tensor, a: torch.Tensor,
                       blk: PartitionAttention
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token half of a block sharded over the model axis, after
    the out-projection's partial sums were added over the model group:
    from x [..., C] and that sum a (fp32, no bias), x1 = x + ls1 (a +
    proj_b) (each step rounded to x's dtype), LayerNorm 2, this rank's
    inner units and their activation, and the partial MLP output p =
    h W_out[:, m]^T in fp32 without its bias. Returns (x1, p)."""
    return _mlp_tp_fn(x, a, *_mlp_tp_weights(blk), blk.mlp.act,
                      blk.mlp.gated, blk.norm2.eps)


def block_residual_plain(x1: torch.Tensor, p: torch.Tensor,
                         blk: PartitionAttention) -> torch.Tensor:
    """The block's last residual from the MLP's output summed over the
    model group p (fp32, no bias): x1 + ls2 (p + out_b), each step
    rounded to x1's dtype."""
    return _residual_fn(x1, p, blk.mlp.proj_out.bias, blk.ls2)


def fused_block_pair_plain(x: torch.Tensor, window_block: PartitionAttention,
                           grid_block: PartitionAttention,
                           partition_size: Tuple[int, int]) -> torch.Tensor:
    """Window block then grid block in token layout (backbone.py:100-106),
    as the modules run them (`layers.block_pair_tokens`)."""
    return block_pair_tokens(x, window_block, grid_block, partition_size)


def lstm_update_plain(x: torch.Tensor, h_prev: torch.Tensor,
                      c_prev: torch.Tensor, gates: _SplitGateConv
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ConvLSTM update (maxvit_pallas.py:163-182): the gate mix
    x Kx + h Kh + b kept in fp32, gates [f, i, o, g]; h' in x's dtype,
    c' in c's dtype."""
    return _lstm_fn(x, h_prev, c_prev, gates.weight, gates.bias)


def fused_stage_plain(x: torch.Tensor, h_prev: torch.Tensor,
                      c_prev: torch.Tensor,
                      block_params: Sequence[Tuple[PartitionAttention,
                                                   PartitionAttention]],
                      lstm_params: _SplitGateConv,
                      partition_size: Tuple[int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All block pairs of a stage, then the ConvLSTM update."""
    for wb, gb in block_params:
        x = fused_block_pair_plain(x, wb, gb, partition_size)
    return lstm_update_plain(x, h_prev, c_prev, lstm_params)


# ---------------------------------------------------------------------------
# Wrappers (the ports of the Pallas functions, same signatures)
# ---------------------------------------------------------------------------

@_build.counted("block_attention")
def block_attention(x: torch.Tensor, blk: PartitionAttention,
                    grid_kind: bool, eps: float = 1e-5, *,
                    cluster: Optional[int] = None) -> torch.Tensor:
    """The attention half of a block (`block_attention_plain`) on an NHWC
    map x [B, H, W, C]: the window (or, with `grid_kind`, grid)
    partition, LayerNorm 1 unless the block skips it, and attention up to
    the output projection, of the block's heads (all of them, or a model
    rank's shard); returns o [B, H, W, heads * dim_head] at the tokens'
    NHWC positions. `cluster` (1, 2, 4, 8 or 16) forces how many CTAs, one head
    group each, share a group of windows (tests only; by default the
    kernel's plan picks). On the card, `block_attention.plan` is the last
    launch's (windows a CTA, CTAs a cluster)."""
    qkv = blk.attn.qkv
    ph, pw = blk.partition_size
    return _build.op("block_attention")(
        x, *_norm1(blk), qkv.weight, qkv.bias, blk.attn.dim_head, ph, pw,
        grid_kind, eps, cluster or 0)


@_build.counted("block_mlp")
def block_mlp(x: torch.Tensor, o: torch.Tensor, blk: PartitionAttention,
              act: str = "gelu", gated: bool = False, eps: float = 1e-5, *,
              cluster: Optional[int] = None) -> torch.Tensor:
    """The per-token half of a block (`block_mlp_plain`) on token rows
    x, o [..., C]. On the card C is one of `kKernelDims`; `cluster` (1, 2, 4
    or 8) forces how many CTAs share a unit of row tiles, splitting its
    hidden chunks (tests only; by default the kernel's plan picks);
    `block_mlp.plan` is the last launch's (CTAs a cluster, 64-row tiles,
    tiles a cluster split, CTAs). While tracing records, a launch adds
    its plan's tiles, split tiles and CTAs to the counters
    `block_mlp.tiles`, `block_mlp.split_tiles` and `block_mlp.ctas`, and
    to the same names for its width (`block_mlp.tiles.c64`, ...)."""
    if blk.mlp.act != act or blk.mlp.gated != gated:
        raise ValueError("block module config disagrees with the call's "
                         "act/gated")
    out = _build.op("block_mlp")(x, o, *_mlp_weights(blk), act, gated, eps,
                                 cluster or 0)
    if timing.tracing() and _counts(x):
        _, tiles, split, ctas = block_mlp.plan
        for name, n in (("tiles", tiles), ("split_tiles", split),
                        ("ctas", ctas)):
            timing.count(f"block_mlp.{name}", n)
            timing.count(f"block_mlp.{name}.c{x.shape[-1]}", n)
    return out


@_build.counted("block_mlp_tp")
def block_mlp_tp(x: torch.Tensor, a: torch.Tensor, blk: PartitionAttention,
                 act: str = "gelu", gated: bool = False, eps: float = 1e-5,
                 *, cluster: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token half of a block sharded over the model axis
    (`block_mlp_tp_plain`) on token rows x [..., C] and the summed
    out-projection a [..., C] (fp32): (x1, this rank's partial MLP output
    p in fp32). On the card `block_mlp_kernel` in its model-axis mode;
    `cluster` and `block_mlp_tp.plan` (the last launch's) as
    `block_mlp`'s."""
    if blk.mlp.act != act or blk.mlp.gated != gated:
        raise ValueError("block module config disagrees with the call's "
                         "act/gated")
    return _build.op("block_mlp_tp")(x, a, *_mlp_tp_weights(blk), act, gated,
                               eps, cluster or 0)


@_build.counted("block_residual")
def block_residual(x1: torch.Tensor, p: torch.Tensor,
                   blk: PartitionAttention) -> torch.Tensor:
    """The last residual of a block sharded over the model axis
    (`block_residual_plain`) on x1 [..., C] and the MLP's output summed
    over the model group p [..., C] (fp32); on the card
    `block_residual_kernel`."""
    return _build.op("block_residual")(x1, p, blk.mlp.proj_out.bias, blk.ls2)


def _tp_half(blk: PartitionAttention, grid_kind: bool, act: str,
             gated: bool, eps: float):
    """A block half sharded over the model axis on an NHWC map: the
    rank's heads (`block_attention`), the out-projection's partial
    product summed over the model group, `block_mlp_tp`, the MLP's
    partial output summed, `block_residual`."""
    def run(y):
        o = block_attention(y, blk, grid_kind, eps)
        # The row-parallel out-projection's partial product o_m W[:, m]^T,
        # whose sum crosses the model ranks before anything else reads
        # it, stays a PyTorch product (fp32 products of the bf16
        # operands): under the model axis the JAX package computes every
        # product of a block through XLA, outside any Pallas kernel (its
        # Pallas kernels are opt-in, `leod_tpu/models/detector.py:40-46`,
        # and `_TP_RULES` act on the flax path).
        a = tensor.reduce_from_model(torch.matmul(
            o.float(), blk.attn.proj.weight.float().t()))
        x1, p = block_mlp_tp(y, a, blk, act, gated, eps)
        return block_residual(x1, tensor.reduce_from_model(p), blk)
    return run


@_build.counted("lstm_update")
def lstm_update(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                gates: _SplitGateConv, *, cluster: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ConvLSTM update (`lstm_update_plain`) on x, h_prev, c_prev of
    one shape [..., C]: h' in x's dtype, c' in c_prev's (bf16 or fp32 on
    the card). On the card C is one of `kKernelDims`; `cluster` (1, 2, 4 or 8)
    forces how many CTAs split K for one tile of rows and channels (tests
    only; by default the kernel's plan picks); `lstm_update.plan` is the
    last launch's (rows a tile, channels a tile, CTAs a cluster)."""
    return _build.op("lstm_update")(x, h_prev, c_prev, gates.weight, gates.bias,
                              cluster or 0)


def _counts(x: torch.Tensor) -> bool:
    """Whether a composite wrapper's call launched kernels: on the card,
    and not while `torch.export` traces it."""
    return x.is_cuda and not torch.compiler.is_compiling()


def fused_block_pair(x: torch.Tensor, window_params: PartitionAttention,
                     grid_params: PartitionAttention,
                     partition_size: Tuple[int, int], skip_first_norm: bool,
                     dim_head: int = 32, act: str = "gelu",
                     gated: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Window block then grid block on an NHWC map x [B, H, W, C], each
    as `block_attention` then `block_mlp`. `*_params` are the port's
    PartitionAttention modules. Inside a space shard (`parallel/space.py`)
    x is a rank's rows: the window block runs on them, and the grid
    block between the grid exchange and its inverse, the kernels
    unchanged (or either on the whole map where the stage's local height
    is not a multiple of the partition). Inside a model shard
    (`parallel/tensor.py`) a block whose weights are sharded runs as
    `_tp_half`: its rank's heads and inner units between the model
    group's all-reduces."""
    _check_block(window_params, skip_first_norm, dim_head, act, gated)
    _check_block(grid_params, False, dim_head, act, gated)
    if tuple(partition_size) != window_params.partition_size:
        raise ValueError("partition_size disagrees with the block modules")
    def half(blk, grid_kind):
        if blk.attn.model_shards > 1:
            return _tp_half(blk, grid_kind, act, gated, eps)
        return lambda y: block_mlp(y, block_attention(y, blk, grid_kind, eps),
                                   blk, act, gated, eps)
    ph = partition_size[0]
    x = space.window_half(half(window_params, False), x, ph)
    x = space.grid_half(half(grid_params, True), x, ph)
    if _counts(x):
        fused_block_pair.launches += 1
    return x


fused_block_pair.launches = 0


def fused_stage(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                block_params: Sequence[Tuple[PartitionAttention,
                                             PartitionAttention]],
                lstm_params: _SplitGateConv,
                partition_size: Tuple[int, int], skip_first_norm: bool,
                dim_head: int = 32, act: str = "gelu", gated: bool = False,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """All block pairs of a stage, then the ConvLSTM update. Returns
    (h', c'); h' is the stage feature, in x's dtype, and c' keeps
    c_prev's dtype. No depthwise-conv LSTM."""
    for i, (wp, gp) in enumerate(block_params):
        x = fused_block_pair(x, wp, gp, partition_size,
                             skip_first_norm and i == 0, dim_head, act,
                             gated, eps)
    out = lstm_update(x, h_prev, c_prev, lstm_params)
    if _counts(x):
        fused_stage.launches += 1
    return out


fused_stage.launches = 0

WRAPPERS = (fused_block_pair, fused_stage, block_attention, block_mlp,
            lstm_update)
# the model axis's variants: launched only by blocks sharded over it
TP_WRAPPERS = (block_mlp_tp, block_residual)
