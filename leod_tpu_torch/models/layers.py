"""Core neural layers (port of `leod_tpu/models/layers.py`).

Public functions take and return NHWC tensors, as in the JAX package.
Convolutions run on an NCHW view of the same memory (a `permute`, no
copy: an NHWC tensor seen as NCHW is PyTorch's channels-last layout).
Parameter names follow the flax modules' names (`norm1`, `attn.qkv`,
`m0`, ...) so `convert.load_jax_variables` maps one tree onto the other
by path. Modules compute in the dtype of their parameters; `Detector`
casts the whole model once.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as pdist
from ..parallel import space, tensor
from ..parallel.space import space_conv2d


def get_act(name: str) -> Callable:
    # jax.nn.gelu defaults to the tanh approximation (layers.py:24)
    return {
        "silu": F.silu, "swish": F.silu, "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.1),
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    }[name]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on NCHW x through `space_conv2d`: the height halo inside a
    space shard, the plain convolution outside one."""
    return space_conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                        conv.groups)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, std 1/sqrt(fan_in)."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(
            torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
            generator=generator))


# ---------------------------------------------------------------------------
# MaxViT pieces
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, wh*ww, C] (local windows)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def window_reverse(x: torch.Tensor, wh: int, ww: int, h: int,
                   w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // wh, w // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def grid_partition(x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*cellH*cellW, gh*gw, C] (dilated global grid):
    the partition size indexes the OUTER, strided dims."""
    b, h, w, c = x.shape
    x = x.reshape(b, gh, h // gh, gw, w // gw, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gh * gw, c)


def grid_reverse(x: torch.Tensor, gh: int, gw: int, h: int,
                 w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // gh, w // gw, gh, gw, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, h, w, c)


def attention_core(x: torch.Tensor, qkv_weight: torch.Tensor,
                   qkv_bias: Optional[torch.Tensor],
                   dim_head: int) -> torch.Tensor:
    """Multi-head attention before the output projection on tokens
    [N, T, C] -> [N, T, heads * dim_head], the qkv projection packed
    head-major (`SelfAttention`). The heads are the weight's rows / (3 *
    dim_head): all of them, or a model rank's shard of them."""
    n, t, _ = x.shape
    heads = qkv_weight.shape[0] // (3 * dim_head)
    qkv = F.linear(x, qkv_weight, qkv_bias).reshape(n, t, heads, 3 * dim_head)
    q, k, v = (u.transpose(1, 2) for u in qkv.split(dim_head, -1))
    attn = (q @ k.transpose(-1, -2)) * dim_head ** -0.5
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return (attn @ v).transpose(1, 2).reshape(n, t, heads * dim_head)


class SelfAttention(nn.Module):
    """MHSA on token sequences [N, T, C]. The qkv projection is packed
    head-major: channel = head*3*dh + {q, k, v}*dh (layers.py:106-108),
    not PyTorch's [q | k | v]. Where `parallel.tensor.shard_params` kept
    a model rank's heads (`model_shards` > 1), the forward runs inside
    `model_shard`: those heads, then the row-parallel projection summed
    over the model group."""

    model_shards = 1

    def __init__(self, dim: int, dim_head: int = 32, use_bias: bool = True):
        super().__init__()
        self.dim, self.dim_head = dim, dim_head
        self.qkv = nn.Linear(dim, 3 * dim, bias=use_bias)
        self.proj = nn.Linear(dim, dim, bias=use_bias)

    def core(self, x: torch.Tensor) -> torch.Tensor:
        """Attention before the output projection: [N, T, C] -> [N, T,
        heads * dim_head] of this module's heads."""
        return attention_core(x, self.qkv.weight, self.qkv.bias,
                              self.dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_shards == 1:
            return self.proj(self.core(x))
        return tensor.row_parallel(self.core(tensor.copy_to_model(x)),
                                   self.proj.weight, self.proj.bias)


def mlp_inner_dim(dim: int, expansion_ratio: int, gated: bool) -> int:
    if gated:
        # param-count-preserving inner dim (layers.py:147)
        return int(dim * expansion_ratio * 2 / 3 / 32) * 32
    return dim * expansion_ratio


def mlp_hidden(x: torch.Tensor, in_weight: torch.Tensor,
               in_bias: Optional[torch.Tensor], act: str,
               gated: bool) -> torch.Tensor:
    """The FFN's activated inner units on [..., C]: act(x W + b), or
    with the gate [value | gate] value * act(gate)."""
    fn = get_act(act)
    h = F.linear(x, in_weight, in_bias)
    if gated:
        h, gate = h.chunk(2, dim=-1)
        return h * fn(gate)
    return fn(h)


def mlp_apply(x: torch.Tensor, in_weight: torch.Tensor,
              in_bias: Optional[torch.Tensor], out_weight: torch.Tensor,
              out_bias: Optional[torch.Tensor], act: str,
              gated: bool) -> torch.Tensor:
    """The FFN of `MLP` on [..., C], from its weights."""
    return F.linear(mlp_hidden(x, in_weight, in_bias, act, gated),
                    out_weight, out_bias)


class MLP(nn.Module):
    """Transformer FFN; optional GLU gate `half * act(half)`. Where
    `parallel.tensor.shard_params` kept a model rank's inner units
    (`model_shards` > 1), the forward runs inside `model_shard`: those
    units, then the row-parallel `proj_out` summed over the model
    group."""

    model_shards = 1

    def __init__(self, dim: int, expansion_ratio: int = 4, act: str = "gelu",
                 gated: bool = False, use_bias: bool = True):
        super().__init__()
        self.act, self.gated = act, gated
        inner = mlp_inner_dim(dim, expansion_ratio, gated)
        self.proj_in = nn.Linear(dim, inner * 2 if gated else inner,
                                 bias=use_bias)
        self.proj_out = nn.Linear(inner, dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_shards == 1:
            return mlp_apply(x, self.proj_in.weight, self.proj_in.bias,
                             self.proj_out.weight, self.proj_out.bias,
                             self.act, self.gated)
        h = mlp_hidden(tensor.copy_to_model(x), self.proj_in.weight,
                       self.proj_in.bias, self.act, self.gated)
        return tensor.row_parallel(h, self.proj_out.weight,
                                   self.proj_out.bias)


class PartitionAttention(nn.Module):
    """Pre-norm window/grid attention + FFN with LayerScale, in token
    form: the input is ALREADY partitioned [N, T, C] for this block's
    partition type, and every op is per token or per window. A block
    sharded over the model axis runs its rank's heads and inner units
    inside `parallel.tensor.model_shard` (`SelfAttention`, `MLP`); the
    residuals, norms and LayerScale see whole tokens on every rank."""

    def __init__(self, dim: int, partition_size: Tuple[int, int],
                 partition_type: str, skip_first_norm: bool = False,
                 dim_head: int = 32, attention_bias: bool = True,
                 mlp_ratio: int = 4, mlp_act: str = "gelu",
                 mlp_gated: bool = False, mlp_bias: bool = True,
                 ls_init_value: float = 1e-5, norm_eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.partition_size = tuple(partition_size)
        self.partition_type = partition_type
        self.skip_first_norm = skip_first_norm
        self.ls_init_value = ls_init_value
        if not skip_first_norm:
            self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = SelfAttention(dim, dim_head, attention_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = MLP(dim, mlp_ratio, mlp_act, mlp_gated, mlp_bias)
        if ls_init_value > 0:
            self.ls1 = nn.Parameter(torch.full((dim,), ls_init_value))
            self.ls2 = nn.Parameter(torch.full((dim,), ls_init_value))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.skip_first_norm else self.norm1(x)
        y = self.attn(y)
        x = x + (y if self.ls1 is None else y * self.ls1)
        y = self.mlp(self.norm2(x))
        return x + (y if self.ls2 is None else y * self.ls2)


def block_pair_tokens(x: torch.Tensor, window_block: PartitionAttention,
                      grid_block: PartitionAttention,
                      partition_size: Tuple[int, int]) -> torch.Tensor:
    """A window block then a grid block on an NHWC map, each run whole on
    its partitioned tokens [N, T, C] (the flax token layout,
    `leod_tpu/models/backbone.py:89-107`): the module forwards, under
    autograd when the caller records it. Inside a space shard the window
    half runs on the rank's rows and the grid half on the exchanged ones
    (`parallel/space.py`)."""
    ph, pw = partition_size

    def window(y):
        _, h, w, _ = y.shape
        return window_reverse(window_block(window_partition(y, ph, pw)),
                              ph, pw, h, w)

    def grid(y):
        _, h, w, _ = y.shape
        return grid_reverse(grid_block(grid_partition(y, ph, pw)), ph, pw,
                            h, w)
    return space.grid_half(grid, space.window_half(window, x, ph), ph)


def _stem_kernel_4c(w_hwio: torch.Tensor) -> torch.Tensor:
    """[7, 7, ci, co] -> HWIO [7, 2, 4ci, co] for the width-folded input:
    output col j covers width blocks j-1 and j, in-block tap 4*bw + s - 1
    (layers.py:275-276)."""
    ci, co = w_hwio.shape[2:]
    k = F.pad(w_hwio, (0, 0, 0, 0, 1, 0))                     # [7, 8, ci, co]
    return k.reshape(7, 2, 4 * ci, co)


def _stem_kernel_16c(w_hwio: torch.Tensor) -> torch.Tensor:
    """[7, 7, ci, co] -> HWIO [2, 2, 16ci, co] for the both-axis fold
    (layers.py:267-270)."""
    ci, co = w_hwio.shape[2:]
    k = F.pad(w_hwio, (0, 0, 0, 0, 1, 0, 1, 0))               # [8, 8, ci, co]
    k = k.reshape(2, 4, 2, 4, ci, co).permute(0, 2, 1, 3, 4, 5)
    return k.reshape(2, 2, 16 * ci, co)


class _S2DStemConv(nn.Module):
    """7x7 stride-4 conv with the space blocks folded into channels.

    `weight` is the plain conv kernel [Cout, Cin, 7, 7] (the flax
    kernel [7, 7, Cin, Cout], transposed). Accepts the three input
    layouts of the JAX module, dispatched on the channel count:
    [B, H, W, Cin], the width fold [B, H, W/4, 4Cin] and the both-axis
    fold [B, H/4, W/4, 16Cin]. Padding is asymmetric, as in JAX:
    H (1, 0), W (1, 0) for 16Cin; H (3, 3), W (1, 0) for 4Cin. Inside a
    space shard the height is padded by the halo (`space_conv2d`)."""

    def __init__(self, dim_out: int, in_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.weight = nn.Parameter(torch.empty(dim_out, in_channels, 7, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cin = self.in_channels
        w_hwio = self.weight.permute(2, 3, 1, 0)
        x = x.to(self.weight.dtype)
        if x.shape[-1] == 16 * cin:
            k = _stem_kernel_16c(w_hwio).permute(3, 2, 0, 1)
            return _nhwc(space_conv2d(_nchw(x), k, padding=(1, 0, 1, 0)))
        k = _stem_kernel_4c(w_hwio).permute(3, 2, 0, 1)
        if x.shape[-1] == cin:                      # fold on device
            b, h, w, _ = x.shape
            if w % 4:
                raise ValueError(f"stem input width {w} is not a multiple of 4")
            x = x.reshape(b, h, w // 4, 4 * cin)
        elif x.shape[-1] != 4 * cin:
            raise ValueError(f"stem input has {x.shape[-1]} channels; "
                             f"expected {cin}, {4 * cin} or {16 * cin}")
        return _nhwc(space_conv2d(_nchw(x), k, stride=(4, 1),
                                  padding=(3, 3, 1, 0)))


def fold_ev_width(ev):
    """Host-side width fold [..., H, W, C] -> [..., H, W/4, 4*C]."""
    *lead, h, w, c = ev.shape
    assert w % 4 == 0, ev.shape
    return ev.reshape(*lead, h, w // 4, 4 * c)


def fold_ev_hw(ev):
    """Host-side both-axis space-to-depth [..., H, W, C] ->
    [..., H/4, W/4, 16*C] for the stride-4 S2D stem (numpy or torch)."""
    *lead, h, w, c = ev.shape
    assert h % 4 == 0 and w % 4 == 0, ev.shape
    x = ev.reshape(*lead, h // 4, 4, w // 4, 4 * c)
    x = np.moveaxis(x, -3, -2) if isinstance(ev, np.ndarray) else \
        torch.movedim(x, -3, -2)
    return x.reshape(*lead, h // 4, w // 4, 16 * c)


def unfold_ev_width(ev):
    """[..., H, W/4, 4*C] -> [..., H, W, C]."""
    *lead, h, w4, c4 = ev.shape
    assert c4 % 4 == 0, ev.shape
    return ev.reshape(*lead, h, w4 * 4, c4 // 4)


def unfold_ev_hw(ev):
    """[..., H/4, W/4, 16*C] -> [..., H, W, C] (numpy or torch)."""
    *lead, h4, w4, c16 = ev.shape
    assert c16 % 16 == 0, ev.shape
    c = c16 // 16
    x = ev.reshape(*lead, h4, w4, 4, 4 * c)
    x = np.moveaxis(x, -2, -3) if isinstance(ev, np.ndarray) else \
        torch.movedim(x, -2, -3)
    return x.reshape(*lead, h4 * 4, w4 * 4, c)


class ConvDownsample(nn.Module):
    """Overlapped strided patch embed + LayerNorm. NHWC in and out."""

    def __init__(self, in_channels: int, dim_out: int, factor: int,
                 overlap: bool = True, norm_affine: bool = True,
                 norm_eps: float = 1e-5):
        super().__init__()
        if overlap and factor == 4:
            self.conv = _S2DStemConv(dim_out, in_channels)
        else:
            if overlap:
                k = (factor - 1) * 2 + 1
                pad = k // 2
            else:
                k, pad = factor, 0
            self.conv = nn.Conv2d(in_channels, dim_out, k, stride=factor,
                                  padding=pad, bias=False)
        # the LayerNorm honours norm_affine (layers.py:364)
        self.norm = nn.LayerNorm(dim_out, eps=norm_eps,
                                 elementwise_affine=norm_affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv, _S2DStemConv):
            x = self.conv(x)
        else:
            x = _nhwc(_conv(self.conv, _nchw(x.to(self.conv.weight.dtype))))
        return self.norm(x)


# ---------------------------------------------------------------------------
# ConvLSTM
# ---------------------------------------------------------------------------

class _SplitGateConv(nn.Module):
    """1x1 conv over concat(x, h), computed as x@Kx + h@Kh without the
    concat. `weight` is the conv kernel [4d, 2d, 1, 1]; gate order along
    the outputs is [forget, input, output, cell_candidate]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.empty(4 * dim, 2 * dim, 1, 1))
        self.bias = nn.Parameter(torch.zeros(4 * dim))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        d = self.dim
        k = self.weight[:, :, 0, 0]
        return (F.linear(x, k[:, :d]) + F.linear(h.to(x.dtype), k[:, d:])
                + self.bias)


class ConvLSTMCell(nn.Module):
    """1x1-conv LSTM over concat(x, h); optional depthwise conv on the
    hidden state (or on both inputs)."""

    def __init__(self, dim: int, dws_conv: bool = False,
                 dws_conv_only_hidden: bool = True,
                 dws_conv_kernel_size: int = 3):
        super().__init__()
        self.dim = dim
        self.dws_conv_only_hidden = dws_conv_only_hidden
        if dws_conv:
            feats = dim if dws_conv_only_hidden else 2 * dim
            ks = dws_conv_kernel_size
            self.dws = nn.Conv2d(feats, feats, ks, padding=ks // 2,
                                 groups=feats)
        else:
            self.dws = None
        self.gates = _SplitGateConv(dim)

    def forward(self, x: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h_prev, c_prev = state
        if self.dws is not None:
            if self.dws_conv_only_hidden:
                h_prev = _nhwc(_conv(self.dws, _nchw(h_prev.to(x.dtype))))
            else:
                xh = _nhwc(_conv(self.dws, _nchw(torch.cat(
                    [x, h_prev.to(x.dtype)], dim=-1))))
                x, h_prev = xh.split(self.dim, dim=-1)
        mix = self.gates(x, h_prev)
        gates, g = mix.split([3 * self.dim, self.dim], dim=-1)
        f, i, o = torch.sigmoid(gates).chunk(3, dim=-1)
        c = f * c_prev + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return h, c


# ---------------------------------------------------------------------------
# YOLO conv blocks (conv + BN + act)
# ---------------------------------------------------------------------------

# flax nn.BatchNorm(momentum=0.9), leod_tpu/models/layers.py:454
BN_MOMENTUM = 0.9


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax `nn.BatchNorm(use_running_average=False, momentum=0.9,
    epsilon=1e-5)` on y [N, C, H, W]: normalize with the batch's mean and
    BIASED variance, and move the running statistics by
    `0.9 * running + 0.1 * batch`, both in fp32 whatever y's dtype.
    torch's own training-mode BN would move `running_var` by the
    unbiased variance instead, so the statistics are taken here and the
    normalization is `F.batch_norm` without running buffers. Every frame
    of y counts, padded ones included, as in the JAX step.

    Inside `parallel.distributed.global_batch` over several ranks, the
    batch is every rank's frames together, as the JAX package's BN over
    a sharded batch takes it (`_global_batch_norm`); inside a space
    shard, every rank's rows of every rank's frames (data x space)."""
    group = space.bn_group()
    if group is None:
        group = pdist.data_group()
    if group is not None and pdist.world_size(group) > 1:
        return _global_batch_norm(y, bn, group)
    with torch.no_grad():
        var, mean = torch.var_mean(y.float(), dim=(0, 2, 3), correction=0)
        _move_running(bn, mean, var)
    return F.batch_norm(y, None, None, bn.weight, bn.bias, True, 0.0,
                        bn.eps)


def _move_running(bn: nn.BatchNorm2d, mean: torch.Tensor,
                  var: torch.Tensor) -> None:
    with torch.no_grad():
        for buf, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            buf.copy_(BN_MOMENTUM * buf.float()
                      + (1.0 - BN_MOMENTUM) * stat.detach())


def _global_batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d,
                       group) -> torch.Tensor:
    """`batch_norm_train` over the frames of every rank of `group`: each
    rank's count, mean and sum of squared deviations (fp32, per
    channel) go to every rank through one differentiable all-reduce,
    and combine as Chan et al.'s parallel variance does (stable where
    the mean is large against the deviation, unlike sum(y^2) - N
    mean^2). The backward all-reduces the statistics' gradients, so each
    rank's input gradient is the global batch's; the running statistics
    move identically on every rank."""
    c = y.shape[1]
    yf = y.float()
    n_local = yf.numel() // c
    mean_l = yf.mean(dim=(0, 2, 3))
    m2_l = (yf - mean_l[:, None, None]).square().sum(dim=(0, 2, 3))
    rows = pdist.all_gather_rows(
        torch.cat([mean_l.new_full((1,), float(n_local)), mean_l, m2_l]),
        group)
    n = rows[:, :1]
    total = n.sum()
    mean = (n * rows[:, 1:c + 1]).sum(0) / total
    var = (rows[:, c + 1:] + n * (rows[:, 1:c + 1] - mean).square()
           ).sum(0) / total
    _move_running(bn, mean, var)
    scale = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return ((yf - mean[:, None, None]) * scale[:, None, None]
            + bn.bias.float()[:, None, None]).to(y.dtype)


class ConvBNAct(nn.Module):
    """conv -> BN -> act, NHWC. `train=False` normalizes with the running
    statistics; `train=True` with the batch's (`batch_norm_train`),
    updating the running ones, as flax's `use_running_average=not
    train`. The module's own train/eval mode plays no part."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, groups: int = 1, act: str = "silu"):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride,
                              padding=(kernel - 1) // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _conv(self.conv, _nchw(x))
        bn = self.bn
        if train:
            y = batch_norm_train(y, bn)
        else:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
        return _nhwc(get_act(self.act)(y))


class DWConvBlock(nn.Module):
    """depthwise kxk + pointwise 1x1."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dconv = ConvBNAct(in_channels, in_channels, kernel, stride,
                               groups=in_channels, act=act)
        self.pconv = ConvBNAct(in_channels, features, 1, 1, act=act)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.pconv(self.dconv(x, train), train)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 act: str = "silu"):
        super().__init__()
        hidden = int(features * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        conv2 = DWConvBlock if depthwise else ConvBNAct
        self.conv2 = conv2(hidden, features, 3, act=act)
        self.use_add = shortcut and in_channels == features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv2(self.conv1(x, train), train)
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """Cross-stage-partial block; bottlenecks are named m0, m1, ..."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(features * expansion)
        self.n = n
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv2 = ConvBNAct(in_channels, hidden, 1, act=act)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, 1.0,
                                              depthwise, act))
        self.conv3 = ConvBNAct(2 * hidden, features, 1, act=act)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x1 = self.conv1(x, train)
        x2 = self.conv2(x, train)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1, train)
        return self.conv3(torch.cat([x1, x2], dim=-1), train)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)
