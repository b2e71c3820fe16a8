"""YOLOX decoupled head and box decoding (port of
`leod_tpu/models/head.py:34-101`; the loss waits for the training slice).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ..config import HeadConfig
from .layers import ConvBNAct, DWConvBlock, _nchw, _nhwc

PRIOR_PROB = 0.01
PRIOR_BIAS = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)


class Anchors(NamedTuple):
    centers: torch.Tensor   # [A, 2] pixel centers: (shift + 0.5) * stride
    shifts: torch.Tensor    # [A, 2] integer grid shifts (x, y)
    strides: torch.Tensor   # [A]
    hw: Tuple[Tuple[int, int], ...]


def make_anchors(in_res_hw: Tuple[int, int], strides: Sequence[int],
                 device="cpu") -> Anchors:
    centers, shifts, strs, hw = [], [], [], []
    for s in strides:
        h, w = in_res_hw[0] // s, in_res_hw[1] // s
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        sh = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).float()
        shifts.append(sh)
        centers.append((sh + 0.5) * s)
        strs.append(torch.full((h * w,), float(s)))
        hw.append((h, w))
    return Anchors(torch.cat(centers).to(device), torch.cat(shifts).to(device),
                   torch.cat(strs).to(device), tuple(hw))


class YOLOXHead(nn.Module):
    """Per-scale stems + decoupled cls/reg branches. Returns raw maps
    [B, h, w, 5+C] per level, channel layout (reg 4, obj 1, cls C)."""

    def __init__(self, cfg: HeadConfig, in_channels: Tuple[int, ...]):
        super().__init__()
        self.cfg = cfg
        self.num_levels = len(in_channels)
        # width follows in_channels[-1]/1024 scaling (head.py:61)
        hidden = int(256 * (in_channels[-1] / 1024))
        conv = DWConvBlock if cfg.depthwise else ConvBNAct
        for k, cin in enumerate(in_channels):
            setattr(self, f"stem{k}", ConvBNAct(cin, hidden, 1, act=cfg.act))
            for j in range(2):
                setattr(self, f"cls_conv{k}_{j}",
                        conv(hidden, hidden, 3, act=cfg.act))
                setattr(self, f"reg_conv{k}_{j}",
                        conv(hidden, hidden, 3, act=cfg.act))
            setattr(self, f"cls_pred{k}", nn.Conv2d(hidden, cfg.num_classes, 1))
            setattr(self, f"reg_pred{k}", nn.Conv2d(hidden, 4, 1))
            setattr(self, f"obj_pred{k}", nn.Conv2d(hidden, 1, 1))

    def forward(self, fpn_feats):
        outs = []
        for k, x in enumerate(fpn_feats):
            x = getattr(self, f"stem{k}")(x)
            cls_f = reg_f = x
            for j in range(2):
                cls_f = getattr(self, f"cls_conv{k}_{j}")(cls_f)
                reg_f = getattr(self, f"reg_conv{k}_{j}")(reg_f)
            cls_out = getattr(self, f"cls_pred{k}")(_nchw(cls_f))
            reg_f = _nchw(reg_f)
            reg_out = getattr(self, f"reg_pred{k}")(reg_f)
            obj_out = getattr(self, f"obj_pred{k}")(reg_f)
            outs.append(_nhwc(torch.cat([reg_out, obj_out, cls_out], 1)))
        return outs


def decode_outputs(raw_levels, anchors: Anchors,
                   apply_sigmoid: bool) -> torch.Tensor:
    """Flatten + decode to absolute boxes [B, A, 4 + 1 + C] (fp32):
    xy = (pred + shift) * stride; wh = exp(pred) * stride; obj/cls stay
    logits unless `apply_sigmoid`."""
    flat = torch.cat([x.reshape(x.shape[0], -1, x.shape[-1])
                      for x in raw_levels], dim=1)
    st = anchors.strides[:, None]
    xy = (flat[..., 0:2] + anchors.shifts) * st
    wh = torch.exp(flat[..., 2:4]) * st
    rest = flat[..., 4:]
    if apply_sigmoid:
        rest = torch.sigmoid(rest)
    return torch.cat([xy, wh, rest.float()], dim=-1)
