"""YOLO PAFPN over backbone stages (2, 3, 4) (port of
`leod_tpu/models/fpn.py:18-56`). NHWC in and out."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import FPNConfig
from .layers import CSPLayer, ConvBNAct, DWConvBlock, upsample2x_nearest


class PAFPN(nn.Module):
    def __init__(self, cfg: FPNConfig, in_channels: Tuple[int, int, int]):
        super().__init__()
        self.cfg = cfg
        n = round(3 * cfg.depth)
        conv = DWConvBlock if cfg.depthwise else ConvBNAct
        c2, c1, c0 = in_channels
        kw = dict(depthwise=cfg.depthwise, act=cfg.act)
        self.lateral_conv0 = ConvBNAct(c0, c1, 1, act=cfg.act)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False, **kw)
        self.reduce_conv1 = ConvBNAct(c1, c2, 1, act=cfg.act)
        self.C3_p3 = CSPLayer(2 * c2, c2, n, False, **kw)
        self.bu_conv2 = conv(c2, c2, 3, 2, act=cfg.act)
        self.C3_n3 = CSPLayer(2 * c2, c1, n, False, **kw)
        self.bu_conv1 = conv(c1, c1, 3, 2, act=cfg.act)
        self.C3_n4 = CSPLayer(2 * c1, c0, n, False, **kw)

    def forward(self, feats: Dict[int, torch.Tensor], train: bool = False):
        """feats {stage_id: [B, h, w, C]} -> (/8, /16, /32) maps.
        train=True runs every BN on batch statistics (`ConvBNAct`)."""
        x2, x1, x0 = (feats[s] for s in self.cfg.in_stages)
        fpn_out0 = self.lateral_conv0(x0, train)                       # /32
        f_out0 = self.C3_p4(torch.cat([upsample2x_nearest(fpn_out0), x1], -1),
                            train)
        fpn_out1 = self.reduce_conv1(f_out0, train)                    # /16
        pan_out2 = self.C3_p3(torch.cat([upsample2x_nearest(fpn_out1), x2],
                                        -1), train)                     # /8
        p_out1 = torch.cat([self.bu_conv2(pan_out2, train), fpn_out1], -1)
        pan_out1 = self.C3_n3(p_out1, train)                           # /16
        p_out0 = torch.cat([self.bu_conv1(pan_out1, train), fpn_out0], -1)
        pan_out0 = self.C3_n4(p_out0, train)                           # /32
        return (pan_out2, pan_out1, pan_out0)
