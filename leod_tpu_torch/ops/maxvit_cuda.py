"""Ports of the Pallas kernels `fused_block_pair` and `fused_stage`
(`leod_tpu/ops/maxvit_pallas.py:254,206`) to hand-written CUDA for
Hopper (`csrc/maxvit.cu`).

Each wrapper dispatches on where its tensor lies: on the CPU it runs the
plain PyTorch version (the token-layout path of the modules,
`leod_tpu/models/backbone.py:89-107`); on a CUDA tensor it launches the
kernels or raises. Each wrapper counts the calls in which it launched
kernels in `.launches`; `block_attention.plan`, `block_mlp.plan` and
`lstm_update.plan` keep how its last launch dealt out the work.

On the card, a block is two launches: `block_attention` (LN1 once per
token, q|k|v on wgmma fed by TMA, attention in registers, a CTA per
group of windows and heads; where windows are few, the head groups of a
window group are a cluster sharing LN1; plain version
`block_attention_plain`) and `block_mlp` (projection, LayerScale,
residual, LN2, MLP, LayerScale, residual, per token, on wgmma fed by TMA;
where few tokens leave the card empty, a cluster of CTAs shares each
row tile's hidden dim; plain version `block_mlp_plain`). `fused_stage` runs its pairs so
and then the ConvLSTM update `lstm_update` (the gate product on wgmma fed
by TMA, the gates in registers; where rows are few and K long, a cluster
of CTAs splits K; plain version `lstm_update_plain`). The kernels take bf16
activations and weights and accumulate in fp32, at the widths and head
widths of RVT-T, RVT-S and RVT-B (`ATTN_SHAPES`, `KERNEL_DIMS`); any
other shape raises on the card.

The three launches are `torch.library` custom ops,
`leod_tpu_torch::block_attention`, `::block_mlp` and `::lstm_update`,
over flat tensors and scalars: the CPU implementation is the plain
version, the CUDA one launches the kernel or raises, and a fake
implementation gives `torch.export` the output's shape and dtype without
building anything. The wrappers below call the ops, so a graph exported
from the serving step (`serve.py` `export_serve_step`) holds them, and
launches counted from such a graph are real launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..parallel import space, tensor
from ..models.layers import (PartitionAttention, _SplitGateConv,
                             attention_core, block_pair_tokens,
                             grid_partition, grid_reverse, mlp_apply,
                             mlp_hidden, window_partition, window_reverse)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "leod_block_attention": [_P] * 6 + [_I] * 9 + [_F, _I, _I, _P, _P],
    "leod_block_mlp": [_P] * 13 + [_I] * 5 + [_F, _I, _P],
    "leod_block_mlp_tp": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    "leod_block_mlp_cluster": [_I] * 5,
    "leod_block_residual": [_P] * 5 + [_I] * 2 + [_P],
    "leod_lstm_update": [_P] * 7 + [_I] * 5 + [_P, _P],
}
_ACTS = {"gelu": 0, "silu": 1, "relu": 2}
# (C, dim_head) pairs `block_attention`'s kernel is built for: the stage
# widths of RVT-T and RVT-B (heads of 32) and of RVT-S (heads of 24)
ATTN_SHAPES = frozenset([(32, 32), (64, 32), (128, 32), (256, 32), (512, 32),
                         (48, 24), (96, 24), (192, 24), (384, 24)])
# the widths C `block_mlp`'s and `lstm_update`'s kernels are built for
KERNEL_DIMS = tuple(sorted(c for c, _ in ATTN_SHAPES))
# (C, heads) pairs `block_attention`'s kernel takes: every head of a
# width, or a model rank's shard of them (`parallel/tensor.py`): at
# heads of 32 a power of two below the width's heads (model degrees 2-16
# of RVT-T and RVT-B), at heads of 24 half of them (RVT-S at degree 2)
ATTN_HEADS = frozenset(
    [(c, c // dh) for c, dh in ATTN_SHAPES]
    + [(c, h) for c, dh in ATTN_SHAPES if dh == 32 for h in (1, 2, 4, 8)
       if h < c // dh]
    + [(c, c // dh // 2) for c, dh in ATTN_SHAPES if dh == 24])
MAX_TOKENS = 80        # block_attention's largest partition ph * pw


def _lib() -> ctypes.CDLL:
    return _build.load("maxvit", _SIGS)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _require_cuda(fn: str, x: torch.Tensor, *weights) -> None:
    """The kernels take contiguous bf16 CUDA tensors, 32-byte aligned for
    the tensor-core tile loads; anything else raises."""
    if not x.is_cuda:
        raise ValueError(f"{fn}: tensor on {x.device}; the kernel runs on "
                         "CUDA and the plain version on the CPU")
    for t in (x,) + weights:
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{fn}: the CUDA kernel takes bf16 tensors on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{fn}: tensors must be contiguous and "
                             "32-byte aligned")


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


def _attention_fn(x, norm_weight, norm_bias, qkv_weight, qkv_bias,
                  dim_head: int, eps: float) -> torch.Tensor:
    if norm_weight is not None:
        x = F.layer_norm(x, (x.shape[-1],), norm_weight, norm_bias, eps)
    return attention_core(x, qkv_weight, qkv_bias, dim_head)


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
# The custom ops: CPU (plain), CUDA (kernel) and fake implementations
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("leod_tpu_torch", "FRAGMENT")
_LIB.define(
    "block_attention(Tensor x, Tensor? norm_weight, Tensor? norm_bias, "
    "Tensor qkv_weight, Tensor? qkv_bias, int dim_head, int ph, int pw, "
    "bool grid_kind, float eps, int cluster) -> Tensor")
_LIB.define(
    "block_mlp(Tensor x, Tensor o, Tensor proj_weight, Tensor? proj_bias, "
    "Tensor? ls1, Tensor norm_weight, Tensor norm_bias, Tensor in_weight, "
    "Tensor? in_bias, Tensor out_weight, Tensor? out_bias, Tensor? ls2, "
    "str act, bool gated, float eps, int cluster) -> Tensor")
_LIB.define(
    "block_mlp_tp(Tensor x, Tensor a, Tensor? proj_bias, Tensor? ls1, "
    "Tensor norm_weight, Tensor norm_bias, Tensor in_weight, "
    "Tensor? in_bias, Tensor out_weight, str act, bool gated, float eps, "
    "int cluster) -> (Tensor, Tensor)")
_LIB.define(
    "block_residual(Tensor x1, Tensor p, Tensor? out_bias, Tensor? ls2) "
    "-> Tensor")
_LIB.define(
    "lstm_update(Tensor x, Tensor h_prev, Tensor c_prev, Tensor weight, "
    "Tensor bias, int cluster) -> (Tensor, Tensor)")


def _partition(grid_kind: bool):
    return ((grid_partition, grid_reverse) if grid_kind
            else (window_partition, window_reverse))


def _attention_cpu(x, norm_weight, norm_bias, qkv_weight, qkv_bias,
                   dim_head, ph, pw, grid_kind, eps, cluster):
    _, h, w, _ = x.shape
    part, rev = _partition(grid_kind)
    return rev(_attention_fn(part(x, ph, pw), norm_weight, norm_bias,
                             qkv_weight, qkv_bias, dim_head, eps),
               ph, pw, h, w)


def _attention_cuda(x, norm_weight, norm_bias, qkv_weight, qkv_bias,
                    dim_head, ph, pw, grid_kind, eps, cluster):
    _require_cuda("block_attention", x, qkv_weight, qkv_bias, norm_weight,
                  norm_bias)
    b, h, w, c = x.shape if x.dim() == 4 else (0,) * 4
    heads = qkv_weight.shape[0] // (3 * dim_head)
    if ((c, dim_head) not in ATTN_SHAPES or (c, heads) not in ATTN_HEADS
            or tuple(qkv_weight.shape) != (3 * heads * dim_head, c)
            or h % ph or w % pw or ph * pw > MAX_TOKENS or b == 0):
        raise ValueError(
            f"block_attention: x [B, H, W, C] with (C, dim_head) in "
            f"{sorted(ATTN_SHAPES)}, qkv [3 heads dim_head, C] with (C, "
            f"heads) in {sorted(ATTN_HEADS)}, H and W multiples of the "
            f"partition, ph * pw <= {MAX_TOKENS}; got {tuple(x.shape)}, "
            f"qkv {tuple(qkv_weight.shape)}, dim_head {dim_head}, "
            f"partition {(ph, pw)}")
    o = x.new_empty(b, h, w, heads * dim_head)
    plan = (ctypes.c_int * 2)()
    _build.check("leod_block_attention", _lib().leod_block_attention(
        x.data_ptr(), o.data_ptr(), _ptr(norm_weight), _ptr(norm_bias),
        qkv_weight.data_ptr(), _ptr(qkv_bias), b, h, w, c, dim_head, heads,
        ph, pw, int(grid_kind), eps, cluster, _num_sms(x.device), plan,
        _stream(x)))
    block_attention.plan = (plan[0], plan[1])
    block_attention.launches += 1
    return o


def _mlp_cpu(x, o, proj_w, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w,
             out_b, ls2, act, gated, eps, cluster):
    return _mlp_fn(x, o, proj_w, proj_b, ls1, norm_w, norm_b, in_w, in_b,
                   out_w, out_b, ls2, act, gated, eps)


def _mlp_cuda(x, o, proj_w, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w,
              out_b, ls2, act, gated, eps, cluster):
    if act not in _ACTS:
        raise ValueError(f"the CUDA block takes act in {sorted(_ACTS)}")
    _require_cuda("block_mlp", x, o, proj_w, proj_b, ls1, norm_w, norm_b,
                  in_w, in_b, out_w, out_b, ls2)
    c = x.shape[-1]
    if o.shape != x.shape or c not in KERNEL_DIMS or x.numel() == 0:
        raise ValueError(f"block_mlp: x and o [..., C] of one shape, C in "
                         f"{KERNEL_DIMS}; got {tuple(x.shape)}, "
                         f"{tuple(o.shape)}")
    lib = _lib()
    rows, inner = x.numel() // c, out_w.shape[1]
    if not cluster:
        # too few row tiles to fill the card: a cluster of CTAs shares
        # each tile's projection columns and hidden chunks
        cluster = lib.leod_block_mlp_cluster(rows, c, inner, int(gated),
                                             _num_sms(x.device))
    out = torch.empty_like(x)
    _build.check("leod_block_mlp", lib.leod_block_mlp(
        x.data_ptr(), o.data_ptr(), out.data_ptr(), proj_w.data_ptr(),
        _ptr(proj_b), _ptr(ls1), norm_w.data_ptr(), norm_b.data_ptr(),
        in_w.data_ptr(), _ptr(in_b), out_w.data_ptr(), _ptr(out_b),
        _ptr(ls2), rows, c, inner, int(gated), _ACTS[act], eps, cluster,
        _stream(x)))
    block_mlp.plan = cluster
    block_mlp.launches += 1
    return out


def _mlp_tp_cpu(x, a, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w, act,
                gated, eps, cluster):
    return _mlp_tp_fn(x, a, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w,
                      act, gated, eps)


def _mlp_tp_cuda(x, a, proj_b, ls1, norm_w, norm_b, in_w, in_b, out_w, act,
                 gated, eps, cluster):
    if act not in _ACTS:
        raise ValueError(f"the CUDA block takes act in {sorted(_ACTS)}")
    _require_cuda("block_mlp_tp", x, proj_b, ls1, norm_w, norm_b, in_w,
                  in_b, out_w)
    c = x.shape[-1]
    inner = out_w.shape[1]
    if (a.shape != x.shape or a.dtype != torch.float32 or not a.is_cuda
            or not a.is_contiguous() or c not in KERNEL_DIMS
            or x.numel() == 0 or tuple(out_w.shape) != (c, inner)
            or in_w.shape[0] != inner * (2 if gated else 1) or inner % 32):
        raise ValueError(
            f"block_mlp_tp: x [..., C] bf16 and a [..., C] fp32 of one shape, "
            f"C in {KERNEL_DIMS}, this rank's inner units a multiple of 32; "
            f"got {tuple(x.shape)}, {tuple(a.shape)} {a.dtype}, proj_out "
            f"{tuple(out_w.shape)}")
    lib = _lib()
    rows = x.numel() // c
    if not cluster:
        cluster = lib.leod_block_mlp_cluster(rows, c, inner, int(gated),
                                             _num_sms(x.device))
    x1 = torch.empty_like(x)
    p = torch.empty_like(a)
    _build.check("leod_block_mlp_tp", lib.leod_block_mlp_tp(
        x.data_ptr(), a.data_ptr(), x1.data_ptr(), p.data_ptr(),
        _ptr(proj_b), _ptr(ls1), norm_w.data_ptr(), norm_b.data_ptr(),
        in_w.data_ptr(), _ptr(in_b), out_w.data_ptr(), rows, c, inner,
        int(gated), _ACTS[act], eps, cluster, _stream(x)))
    block_mlp_tp.plan = cluster
    block_mlp_tp.launches += 1
    return x1, p


def _residual_cpu(x1, p, out_b, ls2):
    return _residual_fn(x1, p, out_b, ls2)


def _residual_cuda(x1, p, out_b, ls2):
    _require_cuda("block_residual", x1, out_b, ls2)
    c = x1.shape[-1]
    if (p.shape != x1.shape or p.dtype != torch.float32 or not p.is_cuda
            or not p.is_contiguous() or c % 8 or x1.numel() == 0):
        raise ValueError(f"block_residual: x1 [..., C] bf16 and p [..., C] "
                         f"fp32 of one shape, C a multiple of 8; got "
                         f"{tuple(x1.shape)}, {tuple(p.shape)} {p.dtype}")
    out = torch.empty_like(x1)
    _build.check("leod_block_residual", _lib().leod_block_residual(
        x1.data_ptr(), p.data_ptr(), _ptr(out_b), _ptr(ls2), out.data_ptr(),
        x1.numel() // c, c, _stream(x1)))
    block_residual.launches += 1
    return out


def _lstm_cpu(x, h_prev, c_prev, weight, bias, cluster):
    return _lstm_fn(x, h_prev, c_prev, weight, bias)


def _lstm_cuda(x, h_prev, c_prev, weight, bias, cluster):
    h_prev = h_prev.to(x.dtype).contiguous()
    w = weight.view(weight.shape[0], -1)                      # [4C, 2C]
    _require_cuda("lstm_update", x, h_prev, w, bias)
    if c_prev.dtype not in (torch.bfloat16, torch.float32) or \
            not c_prev.is_contiguous() or c_prev.device != x.device:
        raise ValueError("lstm_update: c_prev must be a contiguous bf16 or "
                         "fp32 tensor on x's device")
    if c_prev.shape != x.shape or h_prev.shape != x.shape:
        raise ValueError("lstm_update: x, h_prev and c_prev must share a "
                         "shape")
    c = x.shape[-1]
    if c not in KERNEL_DIMS or x.numel() == 0:
        raise ValueError(f"lstm_update: x [..., C] with C in {KERNEL_DIMS}; "
                         f"got {tuple(x.shape)}")
    h_out = torch.empty_like(x)
    c_out = torch.empty_like(c_prev)
    plan = (ctypes.c_int * 3)()
    _build.check("leod_lstm_update", _lib().leod_lstm_update(
        x.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(), w.data_ptr(),
        bias.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        x.numel() // c, c, int(c_prev.dtype == torch.float32), cluster,
        _num_sms(x.device), plan, _stream(x)))
    lstm_update.plan = (plan[0], plan[1], plan[2])
    lstm_update.launches += 1
    return h_out, c_out


for _name, _cpu, _cuda in (("block_attention", _attention_cpu,
                            _attention_cuda),
                           ("block_mlp", _mlp_cpu, _mlp_cuda),
                           ("block_mlp_tp", _mlp_tp_cpu, _mlp_tp_cuda),
                           ("block_residual", _residual_cpu, _residual_cuda),
                           ("lstm_update", _lstm_cpu, _lstm_cuda)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")


@torch.library.register_fake("leod_tpu_torch::block_attention", lib=_LIB)
def _attention_fake(x, norm_weight, norm_bias, qkv_weight, qkv_bias,
                    dim_head, *args):
    return x.new_empty(x.shape[:-1] + (qkv_weight.shape[0] // 3,))


@torch.library.register_fake("leod_tpu_torch::block_mlp", lib=_LIB)
def _mlp_fake(x, *args):
    return torch.empty_like(x)


@torch.library.register_fake("leod_tpu_torch::block_mlp_tp", lib=_LIB)
def _mlp_tp_fake(x, a, *args):
    return torch.empty_like(x), torch.empty_like(a)


@torch.library.register_fake("leod_tpu_torch::block_residual", lib=_LIB)
def _residual_fake(x1, *args):
    return torch.empty_like(x1)


@torch.library.register_fake("leod_tpu_torch::lstm_update", lib=_LIB)
def _lstm_fake(x, h_prev, c_prev, *args):
    return torch.empty_like(x), torch.empty_like(c_prev)


_OPS = torch.ops.leod_tpu_torch


# ---------------------------------------------------------------------------
# Wrappers (the ports of the Pallas functions, same signatures)
# ---------------------------------------------------------------------------

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
    return _OPS.block_attention.default(
        x, *_norm1(blk), qkv.weight, qkv.bias, blk.attn.dim_head, ph, pw,
        grid_kind, eps, cluster or 0)


block_attention.launches = 0
block_attention.plan = None


def block_mlp(x: torch.Tensor, o: torch.Tensor, blk: PartitionAttention,
              act: str = "gelu", gated: bool = False, eps: float = 1e-5, *,
              cluster: Optional[int] = None) -> torch.Tensor:
    """The per-token half of a block (`block_mlp_plain`) on token rows
    x, o [..., C]. On the card C is one of KERNEL_DIMS; `cluster` (1, 2, 4
    or 8) forces how many CTAs share a 64-row tile (tests only; by
    default the kernel's heuristic picks); `block_mlp.plan` is the last
    launch's."""
    if blk.mlp.act != act or blk.mlp.gated != gated:
        raise ValueError("block module config disagrees with the call's "
                         "act/gated")
    return _OPS.block_mlp.default(x, o, *_mlp_weights(blk), act, gated, eps,
                                  cluster or 0)


block_mlp.launches = 0
block_mlp.plan = None


def block_mlp_tp(x: torch.Tensor, a: torch.Tensor, blk: PartitionAttention,
                 act: str = "gelu", gated: bool = False, eps: float = 1e-5,
                 *, cluster: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token half of a block sharded over the model axis
    (`block_mlp_tp_plain`) on token rows x [..., C] and the summed
    out-projection a [..., C] (fp32): (x1, this rank's partial MLP output
    p in fp32). On the card `block_mlp_kernel` in its model-axis mode;
    `cluster` as `block_mlp`'s, `block_mlp_tp.plan` the last launch's."""
    if blk.mlp.act != act or blk.mlp.gated != gated:
        raise ValueError("block module config disagrees with the call's "
                         "act/gated")
    return _OPS.block_mlp_tp.default(x, a, *_mlp_tp_weights(blk), act, gated,
                                     eps, cluster or 0)


block_mlp_tp.launches = 0
block_mlp_tp.plan = None


def block_residual(x1: torch.Tensor, p: torch.Tensor,
                   blk: PartitionAttention) -> torch.Tensor:
    """The last residual of a block sharded over the model axis
    (`block_residual_plain`) on x1 [..., C] and the MLP's output summed
    over the model group p [..., C] (fp32); on the card
    `block_residual_kernel`."""
    return _OPS.block_residual.default(x1, p, blk.mlp.proj_out.bias,
                                       blk.ls2)


block_residual.launches = 0


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


def lstm_update(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                gates: _SplitGateConv, *, cluster: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ConvLSTM update (`lstm_update_plain`) on x, h_prev, c_prev of
    one shape [..., C]: h' in x's dtype, c' in c_prev's (bf16 or fp32 on
    the card). On the card C is one of KERNEL_DIMS; `cluster` (1, 2, 4 or 8)
    forces how many CTAs split K for one tile of rows and channels (tests
    only; by default the kernel's plan picks); `lstm_update.plan` is the
    last launch's (rows a tile, channels a tile, CTAs a cluster)."""
    return _OPS.lstm_update.default(x, h_prev, c_prev, gates.weight,
                                    gates.bias, cluster or 0)


lstm_update.launches = 0
lstm_update.plan = None


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
    if x.is_cuda and ((x.shape[-1], dim_head) not in ATTN_SHAPES
                      or act not in _ACTS):
        raise ValueError(f"the CUDA block takes (C, dim_head) in "
                         f"{sorted(ATTN_SHAPES)} and act in {sorted(_ACTS)}; "
                         f"got ({x.shape[-1]}, {dim_head}), {act!r}")
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
