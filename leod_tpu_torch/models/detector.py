"""Detector: recurrent backbone + PAFPN + YOLOX head (port of
`leod_tpu/models/detector.py:25-128`, inference paths).

The model holds its weights as modules, in the compute dtype: bf16 on
the card, as `Detector(dtype=jnp.bfloat16)` computes (the kernels
accumulate in fp32). Weights are made from a seed with an explicit
`torch.Generator` in flax's initializers' distributions, or loaded from
the JAX package's variables with `convert.load_jax_variables`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import ModelConfig
from .backbone import BackboneStates, RVTBackbone, init_states
from .fpn import PAFPN
from .head import PRIOR_BIAS, Anchors, YOLOXHead, decode_outputs, make_anchors
from .layers import _S2DStemConv, _SplitGateConv, lecun_normal_


class Detector(nn.Module):
    """Inference-mode detector on one device (`cuda` unless the caller
    asks for `cpu`; without a card, `cuda` raises)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = RVTBackbone(cfg.backbone)
        self.fpn = PAFPN(cfg.fpn, cfg.fpn_in_channels)
        self.head = YOLOXHead(cfg.head, cfg.fpn_in_channels)
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device=dev, dtype=dtype)
        self.eval()
        self.requires_grad_(False)
        self.anchors: Anchors = make_anchors(cfg.backbone.in_res_hw,
                                             cfg.head.strides, device=dev)

    @property
    def device(self) -> torch.device:
        return self.anchors.strides.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax defaults: lecun-normal kernels, zero biases, unit norms,
        LayerScale at ls_init_value, mask token N(0, 0.02), and the YOLOX
        prior-probability bias on the cls/obj predictions."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, _S2DStemConv):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, _SplitGateConv):
                lecun_normal_(m.weight, m.weight.shape[1], generator)
            else:
                continue
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("cls_pred", "obj_pred")):
                m.bias.fill_(PRIOR_BIAS)
        for m in self.backbone.modules():
            if getattr(m, "mask_token", None) is not None:
                m.mask_token.copy_(torch.randn(m.mask_token.shape,
                                               generator=generator) * 0.02)

    def init_states(self, batch_size: int, dtype=None) -> BackboneStates:
        return init_states(self.cfg.backbone, batch_size,
                           dtype or self.dtype, self.device)

    @torch.no_grad()
    def forward_backbone(self, x: torch.Tensor, states: BackboneStates,
                         token_mask: Optional[torch.Tensor] = None,
                         plain: bool = False):
        """One timestep: x [B, H, W, C] (or a stem fold of it) ->
        ({stage: feature}, new_states)."""
        return self.backbone(x.to(self.dtype), states, token_mask, plain)

    @torch.no_grad()
    def forward_detect(self, feats, train: bool = False):
        """FPN + head + decode: ([B, A, 5+C] with sigmoided obj/cls, None)."""
        if train:
            raise NotImplementedError(
                "the training forward (batch-stat BN, loss) is not ported yet")
        raw = self.head(self.fpn(feats))
        return decode_outputs(raw, self.anchors, apply_sigmoid=True), None
