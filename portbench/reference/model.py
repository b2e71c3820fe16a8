"""Plain PyTorch RVT detector: the benchmark's reference forward.

A frozen, self-contained copy of the arithmetic of RVT (a 4-stage
recurrent MaxViT backbone: an overlapping strided-conv downsample with
LayerNorm, a window- then a grid-attention block with LayerScale and a
GELU MLP, a 1x1 ConvLSTM), the YOLOX PAFPN and the YOLOX decoupled head
with its box decoding, as LEOD defines it
(`config/model/maxvit_yolox/default.yaml`). It imports nothing of the
program under test and takes nothing it made: the harness hands it the
seeded weights and the raw event frames, and it folds, pads and runs
them itself, in float32 with TF32 off.

Parameter names equal the program's state-dict keys, so one seeded state
dict loads into both.

`Numerics("fp8")` computes under bf16 autocast, as the program does,
and rounds both operands of every matrix product and convolution to
float8 e4m3, and the gradients that flow back into them to e5m2, each
with a per-tensor scale: the lower-precision control the correctness
limits are set against. `Numerics("bf16")` is bf16 autocast alone, a
second witness at the program's own precision.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to the format's largest, and back to x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Fp8(torch.autograd.Function):
    """The forward's operand in e4m3, its gradient in e5m2: fp8
    training's two formats."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Numerics:
    """How the reference computes: "fp32" (the reference), "bf16" (under
    bf16 autocast, as the program states its precision), "fp8" (under
    bf16 autocast with every product's operands in fp8: the step below
    the program's precision, the control)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"numerics {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.kind == "fp8" else x

    def region(self, device_type: str):
        """The context the reference's forward runs in."""
        if self.kind == "fp32":
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=torch.bfloat16)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups)

    def bmm(self, a, b):
        return self.q(a) @ self.q(b)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def unfold_ev_hw(ev: torch.Tensor) -> torch.Tensor:
    """[..., H/4, W/4, 16C] -> [..., H, W, C]: the inverse of the
    host's space-to-depth fold of an event frame."""
    *lead, h4, w4, c16 = ev.shape
    c = c16 // 16
    x = ev.reshape(*lead, h4, w4, 4, 4 * c)
    x = torch.movedim(x, -2, -3)
    return x.reshape(*lead, h4 * 4, w4 * 4, c)


def window_partition(x, wh, ww):
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def window_reverse(x, wh, ww, h, w):
    c = x.shape[-1]
    x = x.reshape(-1, h // wh, w // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def grid_partition(x, gh, gw):
    b, h, w, c = x.shape
    x = x.reshape(b, gh, h // gh, gw, w // gw, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gh * gw, c)


def grid_reverse(x, gh, gw, h, w):
    c = x.shape[-1]
    x = x.reshape(-1, h // gh, w // gw, gh, gw, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, h, w, c)


class Block(nn.Module):
    """Pre-norm multi-head attention over one partition's tokens, then
    the MLP, each added back through a LayerScale. qkv is packed head
    by head: channel = head * 3 * dh + {q, k, v} * dh."""

    def __init__(self, dim, dim_head, mlp_ratio, skip_first_norm):
        super().__init__()
        self.dim, self.dim_head = dim, dim_head
        self.skip_first_norm = skip_first_norm
        if not skip_first_norm:
            self.norm1 = nn.LayerNorm(dim)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.proj_in = nn.Linear(dim, dim * mlp_ratio)
        self.mlp.proj_out = nn.Linear(dim * mlp_ratio, dim)
        self.ls1 = nn.Parameter(torch.zeros(dim))
        self.ls2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x, nm: Numerics):
        n, t, c = x.shape
        dh = self.dim_head
        heads = c // dh
        y = x if self.skip_first_norm else F.layer_norm(
            x, (c,), self.norm1.weight, self.norm1.bias, 1e-5)
        qkv = nm.linear(y, self.attn.qkv.weight, self.attn.qkv.bias)
        q, k, v = qkv.reshape(n, t, heads, 3 * dh).transpose(1, 2).split(dh, -1)
        att = torch.softmax(nm.bmm(q, k.transpose(-1, -2)) * dh ** -0.5, -1)
        o = nm.bmm(att, v).transpose(1, 2).reshape(n, t, c)
        x = x + nm.linear(o, self.attn.proj.weight, self.attn.proj.bias) \
            * self.ls1
        y = F.layer_norm(x, (c,), self.norm2.weight, self.norm2.bias, 1e-5)
        y = gelu(nm.linear(y, self.mlp.proj_in.weight, self.mlp.proj_in.bias))
        y = nm.linear(y, self.mlp.proj_out.weight, self.mlp.proj_out.bias)
        return x + y * self.ls2


class Stage(nn.Module):
    def __init__(self, cin, dim, stride, dim_head, mlp_ratio, partition):
        super().__init__()
        self.stride, self.partition = stride, tuple(partition)
        k = 7 if stride == 4 else 3
        self.down = nn.Module()
        self.down.conv = nn.Module()
        self.down.conv.weight = nn.Parameter(torch.zeros(dim, cin, k, k))
        self.down.norm = nn.LayerNorm(dim)
        self.block0_window = Block(dim, dim_head, mlp_ratio, True)
        self.block0_grid = Block(dim, dim_head, mlp_ratio, False)
        self.lstm = nn.Module()
        self.lstm.gates = nn.Module()
        self.lstm.gates.weight = nn.Parameter(torch.zeros(4 * dim, 2 * dim, 1, 1))
        self.lstm.gates.bias = nn.Parameter(torch.zeros(4 * dim))
        self.dim = dim

    def forward(self, x, state, nm: Numerics):
        """x NHWC; state (h, c) NHWC -> (h, (h, c))."""
        w = self.down.conv.weight
        if self.stride == 4:
            # the 7x7 stride-4 stem, centred at 4i: three rows and
            # columns of zeros before the map and none after
            y = nm.conv(F.pad(nchw(x), (3, 0, 3, 0)), w, stride=4)
        else:
            y = nm.conv(nchw(x), w, stride=2, padding=1)
        y = nhwc(y)
        y = F.layer_norm(y, (self.dim,), self.down.norm.weight,
                         self.down.norm.bias, 1e-5)
        ph, pw = self.partition
        _, h, wd, _ = y.shape
        y = window_reverse(self.block0_window(window_partition(y, ph, pw), nm),
                           ph, pw, h, wd)
        y = grid_reverse(self.block0_grid(grid_partition(y, ph, pw), nm),
                         ph, pw, h, wd)
        h_prev, c_prev = state
        d = self.dim
        kw = self.lstm.gates.weight[:, :, 0, 0]
        mix = (nm.linear(y, kw[:, :d]) + nm.linear(h_prev, kw[:, d:])
               + self.lstm.gates.bias)
        f, i, o = torch.sigmoid(mix[..., :3 * d]).chunk(3, -1)
        c = f * c_prev + i * torch.tanh(mix[..., 3 * d:])
        hh = o * torch.tanh(c)
        return hh, (hh, c)


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm -> SiLU, NHWC. In training the batch
    statistics normalize (the biased variance); else the running ones."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bn = nn.BatchNorm2d(cout)
        self.k, self.stride = k, stride
        self.seen = None        # the last training batch's (mean, var)

    def forward(self, x, nm: Numerics, train: bool):
        y = nm.conv(nchw(x), self.conv.weight, stride=self.stride,
                    padding=(self.k - 1) // 2)
        bn = self.bn
        if train:
            yf = y.float()
            var, mean = torch.var_mean(yf, dim=(0, 2, 3), correction=0)
            self.seen = (mean.detach(), var.detach())
            yf = (yf - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
            y = (yf * bn.weight[:, None, None] + bn.bias[:, None, None]).to(
                y.dtype)
        else:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, 1e-5)
        return nhwc(F.silu(y))


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvBN(c, c, 1)
        self.conv2 = ConvBN(c, c, 3)

    def forward(self, x, nm, train):
        return self.conv2(self.conv1(x, nm, train), nm, train)


class CSP(nn.Module):
    def __init__(self, cin, cout, n):
        super().__init__()
        hid = cout // 2
        self.n = n
        self.conv1 = ConvBN(cin, hid, 1)
        self.conv2 = ConvBN(cin, hid, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hid))
        self.conv3 = ConvBN(2 * hid, cout, 1)

    def forward(self, x, nm, train):
        a = self.conv1(x, nm, train)
        b = self.conv2(x, nm, train)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a, nm, train)
        return self.conv3(torch.cat([a, b], -1), nm, train)


def up2(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


class PAFPN(nn.Module):
    def __init__(self, chans, depth):
        super().__init__()
        n = round(3 * depth)
        c2, c1, c0 = chans
        self.lateral_conv0 = ConvBN(c0, c1, 1)
        self.C3_p4 = CSP(2 * c1, c1, n)
        self.reduce_conv1 = ConvBN(c1, c2, 1)
        self.C3_p3 = CSP(2 * c2, c2, n)
        self.bu_conv2 = ConvBN(c2, c2, 3, 2)
        self.C3_n3 = CSP(2 * c2, c1, n)
        self.bu_conv1 = ConvBN(c1, c1, 3, 2)
        self.C3_n4 = CSP(2 * c1, c0, n)

    def forward(self, x2, x1, x0, nm, train):
        f0 = self.lateral_conv0(x0, nm, train)
        f = self.C3_p4(torch.cat([up2(f0), x1], -1), nm, train)
        f1 = self.reduce_conv1(f, nm, train)
        p2 = self.C3_p3(torch.cat([up2(f1), x2], -1), nm, train)
        p1 = self.C3_n3(torch.cat([self.bu_conv2(p2, nm, train), f1], -1),
                        nm, train)
        p0 = self.C3_n4(torch.cat([self.bu_conv1(p1, nm, train), f0], -1),
                        nm, train)
        return p2, p1, p0


class Head(nn.Module):
    def __init__(self, chans, num_classes):
        super().__init__()
        hid = int(256 * chans[-1] / 1024)
        self.levels = len(chans)
        for k, c in enumerate(chans):
            setattr(self, f"stem{k}", ConvBN(c, hid, 1))
            for j in range(2):
                setattr(self, f"cls_conv{k}_{j}", ConvBN(hid, hid, 3))
                setattr(self, f"reg_conv{k}_{j}", ConvBN(hid, hid, 3))
            for name, out in (("cls_pred", num_classes), ("reg_pred", 4),
                              ("obj_pred", 1)):
                m = nn.Module()
                m.weight = nn.Parameter(torch.zeros(out, hid, 1, 1))
                m.bias = nn.Parameter(torch.zeros(out))
                setattr(self, f"{name}{k}", m)
        # a list: each level's (box input, class input, output map) of
        # the predictions (NCHW)
        self.tap: Optional[List] = None

    def forward(self, feats, nm, train):
        outs = []
        for k, x in enumerate(feats):
            x = getattr(self, f"stem{k}")(x, nm, train)
            cf = rf = x
            for j in range(2):
                cf = getattr(self, f"cls_conv{k}_{j}")(cf, nm, train)
                rf = getattr(self, f"reg_conv{k}_{j}")(rf, nm, train)
            outs.append(self.predict(k, nchw(rf), nchw(cf), nm))
            if self.tap is not None:
                self.tap.append(tuple(t.detach().float() for t in (
                    nchw(rf), nchw(cf), nchw(outs[-1]))))
        return outs

    def predict(self, k: int, rf, cf, nm):
        """Level k's map [B, h, w, 4 + 1 + C] from the inputs of its
        box, objectness and class predictions (NCHW)."""
        pred = [getattr(self, f"{n}{k}") for n in ("reg_pred", "obj_pred",
                                                   "cls_pred")]
        return torch.cat([nhwc(nm.conv(s, p.weight, p.bias))
                          for p, s in zip(pred, (rf, rf, cf))], -1)


class Anchors:
    def __init__(self, in_hw, strides, device):
        centers, shifts, strs = [], [], []
        for s in strides:
            h, w = in_hw[0] // s, in_hw[1] // s
            yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                    indexing="ij")
            sh = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).float()
            shifts.append(sh)
            centers.append((sh + 0.5) * s)
            strs.append(torch.full((h * w,), float(s)))
        self.centers = torch.cat(centers).to(device)
        self.shifts = torch.cat(shifts).to(device)
        self.strides = torch.cat(strs).to(device)


def decode(raw: List[torch.Tensor], anchors: Anchors,
           sigmoid: bool) -> torch.Tensor:
    """Per-level maps [B, h, w, 5 + C] -> [B, A, 5 + C]: centre
    (pred + shift) * stride, size exp(pred) * stride, obj and classes
    as logits or probabilities."""
    flat = torch.cat([x.reshape(x.shape[0], -1, x.shape[-1]) for x in raw], 1)
    st = anchors.strides[:, None]
    xy = (flat[..., :2] + anchors.shifts) * st
    wh = torch.exp(flat[..., 2:4]) * st
    rest = flat[..., 4:]
    return torch.cat([xy, wh, torch.sigmoid(rest) if sigmoid else rest], -1)


class RVTDetector(nn.Module):
    """RVT + PAFPN + YOLOX head from a configuration file's `model`
    block (the keys `portbench/configs/*.json` state)."""

    def __init__(self, m: Dict):
        super().__init__()
        self.m = m
        dims = [m["embed_dim"] * k for k in m["dim_multiplier"]]
        self.dims = dims
        self.in_hw = tuple(m["in_res_hw"])
        self.strides_bb = [4, 8, 16, 32]
        self.backbone = nn.Module()
        cin = m["input_channels"]
        for i, d in enumerate(dims):
            setattr(self.backbone, f"stage{i + 1}", Stage(
                cin, d, 4 if i == 0 else 2, m["dim_head"], m["mlp_ratio"],
                m["partition_size"]))
            cin = d
        chans = tuple(dims[s - 1] for s in m["fpn_in_stages"])
        self.fpn = PAFPN(chans, m["fpn_depth"])
        self.head = Head(chans, m["num_classes"])

    def zero_states(self, b, device, dtype=torch.float32):
        h, w = self.in_hw
        return [tuple(torch.zeros(b, h // s, w // s, d, device=device,
                                  dtype=dtype) for _ in range(2))
                for d, s in zip(self.dims, self.strides_bb)]

    def backbone_step(self, x, states, nm: Numerics):
        """One timestep: x [B, H, W, C] float (padded) -> (features of
        the FPN's stages, new states)."""
        feats = []
        new = []
        for i in range(4):
            x, st = getattr(self.backbone, f"stage{i + 1}")(x, states[i], nm)
            feats.append(x)
            new.append(st)
        return [feats[s - 1] for s in self.m["fpn_in_stages"]], new

    def detect(self, feats, anchors, nm: Numerics, train: bool,
               sigmoid: bool):
        p = self.fpn(*feats, nm, train)
        return decode(self.head(p, nm, train), anchors, sigmoid)


def reset_rows(states, reset: torch.Tensor):
    r = reset.reshape(-1, 1, 1, 1)
    return [tuple(torch.where(r, torch.zeros_like(s), s) for s in st)
            for st in states]


def fold_frames(frames: torch.Tensor, in_hw: Sequence[int]) -> torch.Tensor:
    """Raw event frames [..., C, H, W] (uint8) -> padded float NHWC
    [..., in_h, in_w, C], zeros below and to the right."""
    x = torch.movedim(frames, -3, -1).float()
    h, w = x.shape[-3:-1]
    return F.pad(x, (0, 0, 0, in_hw[1] - w, 0, in_hw[0] - h))


def param_groups(model: nn.Module) -> Tuple[List[str], List[str]]:
    """(weight-like names, names of vectors) of the state dict."""
    return ([n for n, p in model.named_parameters() if p.dim() > 1],
            [n for n, p in model.named_parameters() if p.dim() <= 1])


def lecun_std(shape: Sequence[int]) -> float:
    fan_in = math.prod(shape[1:])
    return 1.0 / math.sqrt(fan_in)
